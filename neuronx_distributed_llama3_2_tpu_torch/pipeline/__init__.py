"""Pipeline parallelism: the schedules' task lists and the stage executor."""

from neuronx_distributed_llama3_2_tpu_torch.pipeline.scheduler import (  # noqa: F401
    InferenceSchedule,
    Train1F1BSchedule,
    TrainGPipeSchedule,
)
from neuronx_distributed_llama3_2_tpu_torch.pipeline.model import (  # noqa: F401
    PipelinedCausalLM,
)
