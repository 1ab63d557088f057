from neurec_tpu_torch.models.general import (  # noqa: F401  (registers each model)
    apr,
    convncf,
    deepicf,
    dmf,
    fism,
    lightgcn,
    mf,
    mlp,
    nais,
    neumf,
    ngcf,
)
