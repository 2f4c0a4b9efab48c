"""Model-FLOP arithmetic for MFU, and the H100's peaks.

Counterpart of ``neuronx_distributed_llama3_2_tpu/flops.py``: the same
formulas (a forward costs ``2·N`` matmul FLOPs per token plus ``4·L·H·K``
of attention at context ``K``; training is three forwards, ``6·N +
12·L·H·S``). The peaks are the H100 SXM's (NVIDIA data sheet, dense, at
the full 700 W power limit); a card set to a lower limit runs slower under
load, so an MFU is stated beside the card's power limit.
"""

from __future__ import annotations

H100_BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core FLOP/s
H100_FP8_FLOPS_PER_S = 1979e12       # dense fp8 tensor-core FLOP/s
H100_INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core OP/s
H100_HBM_BYTES = 80e9                # device memory
H100_HBM_BYTES_PER_S = 3.35e12       # device memory bandwidth


def model_flops_per_token(
    num_params: int,
    num_layers: int,
    hidden_size: int,
    context_len: int,
    backward: bool = False,
) -> float:
    """Per-token model FLOPs at attention context ``context_len``:
    ``2·N + 4·L·H·K`` forward, ×3 with the backward pass."""
    fwd = 2 * num_params + 4 * num_layers * hidden_size * context_len
    return 3.0 * fwd if backward else float(fwd)


def train_flops_per_token(
    num_params: int, num_layers: int, hidden_size: int, seq_len: int
) -> float:
    """Per-token training FLOPs (``6·N + 12·L·H·S``)."""
    return model_flops_per_token(
        num_params, num_layers, hidden_size, seq_len, backward=True
    )


def mfu(
    tokens_per_sec: float,
    num_params: int,
    num_layers: int,
    hidden_size: int,
    seq_len: int,
    peak_flops_per_s: float = H100_BF16_FLOPS_PER_S,
) -> float:
    """Model FLOPs utilization of one device (training convention)."""
    achieved = tokens_per_sec * train_flops_per_token(
        num_params, num_layers, hidden_size, seq_len
    )
    return achieved / peak_flops_per_s
