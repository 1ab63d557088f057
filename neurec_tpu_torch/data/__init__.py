from neurec_tpu_torch.data.dataset import Dataset  # noqa: F401
