from neurec_tpu_torch.models.base import Recommender, get_model, register, registered_models

__all__ = ["Recommender", "get_model", "register", "registered_models"]
