"""Channel-parallel 2D convolutions (the vision tower's tensor-parallel
layers), in PyTorch.

Counterpart of ``neuronx_distributed_llama3_2_tpu/parallel/conv.py``
(``OutputChannelParallelConv2d`` :86, ``InputChannelParallelConv2d`` :108;
the reference's ``parallel_layers/layers.py`` :1033 / :1134). The
parameters keep the JAX layout: an HWIO ``kernel`` (kh, kw, in, out) and an
``(out,)`` ``bias``. A rank holds the shard the JAX ``specs()`` give it:

- ``OutputChannelParallelConv2d``: ``kernel`` (kh, kw, in, out/tp), ``bias``
  (out/tp,). Its input is replicated (copied into the tp region: the input
  gradient is all-reduced); the output is this rank's channels, all-gathered
  over tp with ``gather_output``;
- ``InputChannelParallelConv2d``: ``kernel`` (kh, kw, in/tp, out), ``bias``
  (out,) replicated. Its input arrives with this rank's channels (the
  output of an output-channel layer without the gather); the partial sums
  are all-reduced, then the bias is added.

``forward`` takes and returns NHWC activations, as the JAX layers do, and
permutes around ``F.conv2d`` (NCHW, with the kernel permuted to OIHW);
:meth:`_ParallelConv2d.forward_nchw` takes and returns NCHW, which the
vision tower's pixels already are.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from neuronx_distributed_llama3_2_tpu_torch.parallel import state as parallel_state
from neuronx_distributed_llama3_2_tpu_torch.parallel.layers import (
    KERNEL_INIT_STD,
    divide,
    normal_init_,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import LeafSpec
from neuronx_distributed_llama3_2_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
)

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class _ParallelConv2d(nn.Module):
    """What both channel-parallel layers share (JAX ``_ParallelConv2d``):
    the HWIO kernel split over tp along ``split_dim`` (3 = out, 2 = in)."""

    split_dim = 3

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair, *,
                 stride: IntPair = 1, padding: IntPair = 0, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.tp = parallel_state.tensor_parallel_size_or(1)
        self.tp_rank = parallel_state.tensor_parallel_rank_or(0)
        self.stride, self.padding = _pair(stride), _pair(padding)
        kh, kw = _pair(kernel_size)
        self.full_shape = (kh, kw, in_channels, out_channels)
        shape = list(self.full_shape)
        shape[self.split_dim] = divide(shape[self.split_dim], self.tp)
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        bias_len = shape[3] if self.split_dim == 3 else out_channels
        self.bias = (nn.Parameter(torch.empty((bias_len,), dtype=dtype, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """N(0, 0.02) kernel (JAX ``default_kernel_init``), drawn whole and
        cut to this rank's shard; zero bias."""
        normal_init_(self.kernel, generator, KERNEL_INIT_STD, self.full_shape,
                     self.split_dim, self.tp_rank)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def specs(self) -> dict:
        """name -> :class:`..parallel.layout.LeafSpec` (JAX ``specs()``)."""
        T = parallel_state.TP_AXIS
        spec = [None, None, None, None]
        spec[self.split_dim] = T
        out = {"kernel": LeafSpec(self.full_shape, tuple(spec))}
        if self.bias is not None:
            out["bias"] = LeafSpec((self.full_shape[3],), (T if self.split_dim == 3 else None,))
        return out

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW ``x`` with this rank's kernel (OIHW for ``conv2d``), no bias."""
        w = self.kernel.permute(3, 2, 0, 1)
        return nn.functional.conv2d(x, w, stride=self.stride, padding=self.padding)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out (the JAX layers' layout)."""
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class OutputChannelParallelConv2d(_ParallelConv2d):
    """Conv2d split along the output channels (JAX :86). With
    ``gather_output`` every rank gets all of them; otherwise the channel dim
    stays split for a following :class:`InputChannelParallelConv2d`."""

    split_dim = 3

    def __init__(self, *args, gather_output: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.gather_output = gather_output

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(copy_to_tensor_model_parallel_region(x))
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y, 1)
        return y


class InputChannelParallelConv2d(_ParallelConv2d):
    """Conv2d split along the input channels (JAX :108): the partial sums of
    this rank's channels all-reduced, the replicated bias added after."""

    split_dim = 2

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_tensor_model_parallel_region(self._conv(x))
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y
