"""Framework-wide constants (copy of the ones mafed_tpu/constants.py defines
that the port uses)."""

# EVA-02 large @224/patch14 gives 16x16 = 256 patch tokens once the CLS token
# is dropped.
NUM_VISION_TOKENS = 256

# Labels value that the LM loss ignores (HF convention).
IGNORE_INDEX = -100

# Generation budget for VQA answers (greedy decode).
MAX_NEW_TOKENS = 10

# Early-stopping min-delta on generative VQA accuracy.
PATIENCE_THRESHOLD = 5e-5
