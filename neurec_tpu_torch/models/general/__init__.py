from neurec_tpu_torch.models.general import lightgcn, mf, ngcf  # noqa: F401  (registers LightGCN, MF, NGCF)
