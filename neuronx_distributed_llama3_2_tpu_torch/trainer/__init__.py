"""Training on one device or over a tensor / context / pipeline /
data-parallel mesh (ZeRO-1):
configuration, AdamW, the train and eval steps,
and the TensorBoard scalar writer."""

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
    optimizer_state_specs,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.tensorboard import (  # noqa: F401
    TensorBoardLogger,
)
from neuronx_distributed_llama3_2_tpu_torch.trainer.trainer import (  # noqa: F401
    TrainState,
    default_weight_decay_mask,
    dp_rows,
    evaluate,
    initialize_parallel_model,
    make_eval_step,
    make_train_step,
    state_specs,
)
