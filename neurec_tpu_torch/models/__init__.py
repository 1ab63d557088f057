from neurec_tpu_torch.models.base import Recommender, get_model, register, registered_models

# the port's models beyond the JAX zoo (held to plain references of their own)
PORT_ONLY = ("HSTU",)

__all__ = ["PORT_ONLY", "Recommender", "get_model", "register", "registered_models"]
