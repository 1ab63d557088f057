from neurec_tpu_torch.models.social import diffnet, sbpr  # noqa: F401  (registers each model)
