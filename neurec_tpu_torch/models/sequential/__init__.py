from neurec_tpu_torch.models.sequential import (  # noqa: F401  (registers each model)
    caser,
    fossil,
    fpmc,
    fpmcplus,
    gru4rec,
    gru4recplus,
    hrm,
    hstu,
    npe,
    sasrec,
    srgnn,
    transrec,
)
