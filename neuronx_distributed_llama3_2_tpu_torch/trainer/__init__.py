"""Single-device training: configuration, AdamW, the train and eval steps.
``TensorBoardLogger`` is not ported yet (``ROADMAP.md``)."""

from neuronx_distributed_llama3_2_tpu_torch.trainer.config import (  # noqa: F401
    OptimizerConfig,
    TrainingConfig,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.metrics import (  # noqa: F401
    Throughput,
    TrainingMetrics,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.optimizer import (  # noqa: F401
    OptimizerState,
    apply_gradients,
    init_optimizer_state,
    opt_state_from_jax,
    opt_state_to_jax,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import (  # noqa: F401
    TrainState,
    default_weight_decay_mask,
    evaluate,
    initialize_parallel_model,
    make_eval_step,
    make_train_step,
)
