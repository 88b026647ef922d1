"""K3: row gathers of per-triangle attribute tables, CUDA kernel and plain
version (port of ignis_tpu/ops/gather.py).

`gather_cols(idx, cols)` stacks K f32 columns ([T] each) into one [T, K]
table and fetches its rows at idx ([N] int32, in [0, T)); `gather_table`
does the same for a table built once beforehand. The forward is
csrc/gather_cols.cu `ig_gather_rows` for tensors on the card, which
replaces ignis_tpu/ops/gather.py::_gather_kernel; its backward, the
`GatherCols` autograd Function, is `ig_scatter_add_rows` there, which
replaces the VJP _gather_cols_bwd. For tensors on the CPU both take their
plain versions: `tab[idx]` and `index_add_`. `gather_counts` and
`scatter_counts` hold the kernels' launches and the plain versions' calls.

The JAX package's `take_rows` (a `select_n` tree for small tables, TPU
machinery) is plain indexing here, and its callers index directly.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

gather_counts = cuda_build.Counts()
scatter_counts = cuda_build.Counts()
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _kernel(entry: str):
    return cuda_build.load_kernel("gather_cols", entry, _ARGTYPES)


def build() -> None:
    """Compile (or load) the kernel library."""
    _kernel("ig_gather_rows")
    _kernel("ig_scatter_add_rows")


def reset_counts() -> None:
    gather_counts.reset()
    scatter_counts.reset()


def gather_rows_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    gather_counts["plain_calls"] += 1
    return tab[idx.long()]


def scatter_add_rows_plain(idx: torch.Tensor, g: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    scatter_counts["plain_calls"] += 1
    return torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                       device=g.device).index_add_(0, idx.long(), g)


def _check(what, idx, mat):
    device = idx.device
    cuda_build.check_inputs(f"{what} idx", device, idx.numel(), idx,
                            dtype=torch.int32)
    cuda_build.check_inputs(f"{what} table", device, mat.numel(), mat)
    if mat.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D table, got {mat.dim()}-D")


def gather_rows(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """tab[idx] ([N, K]): the K3 kernel on the card, the plain version on
    the CPU."""
    device = idx.device
    if device.type == "cpu":
        return gather_rows_plain(idx, tab)
    if device.type != "cuda":
        raise ValueError(f"K3 has no kernel for device {device}")
    idx, tab = idx.contiguous(), tab.contiguous()
    _check("K3 gather", idx, tab)
    n, (t, k) = idx.numel(), tab.shape
    out = torch.empty((n, k), dtype=torch.float32, device=device)
    if n and k and t:
        cuda_build.launch("K3 gather_rows", gather_counts,
                          _kernel("ig_gather_rows"), idx.data_ptr(),
                          tab.data_ptr(), out.data_ptr(), n, k, t,
                          torch.cuda.current_stream(device).cuda_stream)
    return out


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """zeros(n_rows, K).index_add_(0, idx, g): the K3 scatter kernel on
    the card, the plain version on the CPU."""
    device = idx.device
    if device.type == "cpu":
        return scatter_add_rows_plain(idx, g, n_rows)
    if device.type != "cuda":
        raise ValueError(f"K3 has no kernel for device {device}")
    idx, g = idx.contiguous(), g.contiguous()
    _check("K3 scatter", idx, g)
    n, k = g.shape
    if idx.numel() != n:
        raise ValueError(f"K3 scatter: {idx.numel()} indices for {n} rows")
    dtab = torch.zeros((n_rows, k), dtype=torch.float32, device=device)
    if n and k and n_rows:
        cuda_build.launch("K3 scatter_add_rows", scatter_counts,
                          _kernel("ig_scatter_add_rows"), idx.data_ptr(),
                          g.data_ptr(), dtab.data_ptr(), n, k, n_rows,
                          torch.cuda.current_stream(device).cuda_stream)
    return dtab


class GatherCols(torch.autograd.Function):
    """tab[idx], differentiable in the table (scatter-add backward)."""

    @staticmethod
    def forward(ctx, idx, tab):
        ctx.save_for_backward(idx)
        ctx.n_rows = tab.shape[0]
        return gather_rows(idx, tab)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, scatter_add_rows(idx, g, ctx.n_rows)


def stack_cols(cols) -> torch.Tensor:
    """The [T, K] f32 table of K columns."""
    return torch.stack([c.to(torch.float32) for c in cols], dim=1)


def gather_table(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """tab[idx]; recorded for reverse mode only when grad mode is on and
    the table requires grad."""
    if torch.is_grad_enabled() and tab.requires_grad:
        return GatherCols.apply(idx, tab)
    return gather_rows(idx, tab)


def gather_cols(idx: torch.Tensor, cols) -> list:
    """The len(cols) columns ([T] each) at idx ([N] int32, clamped into
    range) as a list of [N] tensors, through one [T, K] row gather."""
    return list(gather_table(idx, stack_cols(cols)).unbind(1))
