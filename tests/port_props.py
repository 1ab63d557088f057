"""Properties of the port's models beyond the JAX zoo (``neurec_tpu_torch.
models.PORT_ONLY``) for the tests that run every registered model on the
zoo's 60 x 80 synthetic set: small widths, as the zoo's own properties
(``tests/test_zoo_sharding.py::_props_for``), which give every other
model's."""

from tests.test_zoo_sharding import _props_for

PORT_PROPS = {
    "HSTU": {
        "item_embedding_dim": 8, "num_blocks": 2, "num_heads": 2, "dqk": 4, "dv": 4,
        "max_sequence_length": 16, "num_negatives": 8, "temperature": 0.05, "dropout_rate": 0.2,
        "lr": 0.01, "batch_size": 16, "epochs": 1, "verbose": 1,
    },
}


def props_for(name, social):
    """A registered model's properties: the port's own model's here, a JAX
    zoo model's from the zoo's tests (``social`` the friendship file)."""
    return dict(PORT_PROPS[name]) if name in PORT_PROPS else _props_for(name, social)
