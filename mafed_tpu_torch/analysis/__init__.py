from mafed_tpu_torch.analysis.cka import cka_from_gram, feature_space_linear_cka, gram_linear, gram_rbf

__all__ = ["cka_from_gram", "feature_space_linear_cka", "gram_linear", "gram_rbf"]
