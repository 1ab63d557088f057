from neurec_tpu_torch.eval.evaluator import (  # noqa: F401
    Evaluator,
    GroupedEvaluator,
    UniEvaluator,
)
