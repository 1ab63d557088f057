from neurec_tpu_torch.models.general import lightgcn, mf  # noqa: F401  (registers LightGCN, MF)
