from neurec_tpu_torch.models.general import lightgcn  # noqa: F401  (registers LightGCN)
