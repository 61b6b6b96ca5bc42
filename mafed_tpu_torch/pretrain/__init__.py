from mafed_tpu_torch.pretrain.dataset import CaptionRecord, PretrainDataset, collate_pretrain
from mafed_tpu_torch.pretrain.trainer import PretrainConfig, PretrainTrainer

__all__ = ["CaptionRecord", "PretrainDataset", "collate_pretrain", "PretrainConfig", "PretrainTrainer"]
