"""K3: row gathers of per-triangle attribute tables, CUDA kernel and plain
version (port of ignis_tpu/ops/gather.py).

A table is [T, S] f32 whose row stride S is a multiple of 4: `stack_cols`
stacks K columns ([T] each) and pads them with zero columns up to S, so
each row is whole 16-byte words. `gather_block(idx, tab, k)` fetches the
first k columns of the rows at idx ([N] int32, in [0, T)) as a [k, N]
column block, whose row c is column c at every lane, contiguous: the K
separate [N] columns that the JAX function returns. The forward is
csrc/gather_cols.cu `ig_gather_rows` for tensors on the card, which
replaces ignis_tpu/ops/gather.py::_gather_kernel; its backward, the
`GatherCols` autograd Function, is `ig_scatter_add_rows` there, which
replaces the VJP _gather_cols_bwd and gives the padding columns no
gradient. For tensors on the CPU both take their plain versions:
`tab[idx]` and `index_add_`. `gather_counts` and `scatter_counts` hold the
kernels' launches and the plain versions' calls.

The JAX package's `take_rows` (a `select_n` tree for small tables, TPU
machinery) is plain indexing here, and its callers index directly.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

gather_counts = cuda_build.Counts()
scatter_counts = cuda_build.Counts()
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_STRIDE = 32   # the kernels take rows of up to 8 float4s


def _kernel(entry: str):
    return cuda_build.load_kernel("gather_cols", entry, _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel("ig_gather_rows")
    _kernel("ig_scatter_add_rows")


def reset_counts() -> None:
    gather_counts.reset()
    scatter_counts.reset()


def padded_width(k: int) -> int:
    """K rounded up to a multiple of 4: the row stride of a K-column table."""
    return -(-k // 4) * 4


def gather_rows_plain(idx: torch.Tensor, tab: torch.Tensor,
                      k: int) -> torch.Tensor:
    gather_counts["plain_calls"] += 1
    return tab[idx.long(), :k].t().contiguous()


def scatter_add_rows_plain(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                           stride: int) -> torch.Tensor:
    scatter_counts["plain_calls"] += 1
    dtab = torch.zeros((n_rows, stride), dtype=g.dtype, device=g.device)
    dtab[:, :g.shape[0]].index_add_(0, idx.long(), g.t())
    return dtab


def _check(what, idx, mat, k, stride):
    device = idx.device
    cuda_build.check_inputs(f"{what} idx", device, idx.numel(), idx,
                            dtype=torch.int32)
    cuda_build.check_inputs(f"{what} table", device, mat.numel(), mat)
    if not (0 < k <= stride <= MAX_STRIDE and stride % 4 == 0):
        raise ValueError(f"{what}: {k} columns of rows of {stride} floats; "
                         f"the kernel takes a row stride that is a multiple "
                         f"of 4 up to {MAX_STRIDE} (stack_cols pads to it)")


def gather_rows(idx: torch.Tensor, tab: torch.Tensor, k: int) -> torch.Tensor:
    """The [k, N] column block tab[idx, :k].T: the K3 kernel on the card,
    the plain version on the CPU."""
    device = idx.device
    if device.type == "cpu":
        return gather_rows_plain(idx, tab, k)
    if device.type != "cuda":
        raise ValueError(f"K3 has no kernel for device {device}")
    idx, tab = idx.contiguous(), tab.contiguous()
    t, stride = tab.shape
    _check("K3 gather", idx, tab, k, stride)
    if tab.data_ptr() % 16:
        raise ValueError("K3 gather: table not 16-byte aligned")
    n = idx.numel()
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    if n and t:
        cuda_build.launch("K3 gather_rows", gather_counts,
                          _kernel("ig_gather_rows"), idx.data_ptr(),
                          tab.data_ptr(), out.data_ptr(), n, k, stride, t,
                          torch.cuda.current_stream(device).cuda_stream)
    return out


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                     stride: int) -> torch.Tensor:
    """The [n_rows, stride] gradient of a gather: the [k, N] cotangent
    block g added at rows idx into zeros, columns k and above zero. The K3
    scatter kernel on the card, the plain version on the CPU."""
    device = idx.device
    if device.type == "cpu":
        return scatter_add_rows_plain(idx, g, n_rows, stride)
    if device.type != "cuda":
        raise ValueError(f"K3 has no kernel for device {device}")
    idx, g = idx.contiguous(), g.contiguous()
    k, n = g.shape
    _check("K3 scatter", idx, g, k, stride)
    if idx.numel() != n:
        raise ValueError(f"K3 scatter: {idx.numel()} indices for {n} lanes")
    dtab = torch.zeros((n_rows, stride), dtype=torch.float32, device=device)
    if n and n_rows:
        cuda_build.launch("K3 scatter_add_rows", scatter_counts,
                          _kernel("ig_scatter_add_rows"), idx.data_ptr(),
                          g.data_ptr(), dtab.data_ptr(), n, k, stride, n_rows,
                          torch.cuda.current_stream(device).cuda_stream)
    return dtab


class GatherCols(torch.autograd.Function):
    """The [k, N] column block of tab at idx, differentiable in the table
    (scatter-add backward)."""

    @staticmethod
    def forward(ctx, idx, tab, k):
        ctx.save_for_backward(idx)
        ctx.shape = tab.shape
        return gather_rows(idx, tab, k)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, scatter_add_rows(idx, g, *ctx.shape), None


def stack_cols(cols) -> torch.Tensor:
    """The [T, S] f32 table of K columns, S = padded_width(K); the columns
    past K are zeros and get no gradient."""
    cols = [c.to(torch.float32) for c in cols]
    pad = padded_width(len(cols)) - len(cols)
    return torch.stack(cols + [torch.zeros_like(cols[0])] * pad, dim=1)


def gather_block(idx: torch.Tensor, tab: torch.Tensor,
                 k: int = None) -> torch.Tensor:
    """The [k, N] column block of tab's first k columns (all by default) at
    idx; recorded for reverse mode only when grad mode is on and the table
    requires grad."""
    k = tab.shape[1] if k is None else k
    if torch.is_grad_enabled() and tab.requires_grad:
        return GatherCols.apply(idx, tab, k)
    return gather_rows(idx, tab, k)


def gather_table(idx: torch.Tensor, tab: torch.Tensor,
                 k: int = None) -> torch.Tensor:
    """tab[idx, :k] ([N, k]), as a view of gather_block's column block."""
    return gather_block(idx, tab, k).t()


def gather_cols(idx: torch.Tensor, cols) -> list:
    """The len(cols) columns ([T] each) at idx ([N] int32, clamped into
    range) as a list of contiguous [N] tensors, through one row gather of
    their padded table."""
    return list(gather_block(idx, stack_cols(cols), len(cols)).unbind(0))
