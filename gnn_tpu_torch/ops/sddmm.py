"""Occupied-tile SDDMM (K5): the counterpart of `gnn_tpu.ops.pallas_sddmm`.

``out[j] = X[rt_j tile] @ Y[ct_j tile]^T`` on the tiles of a stream
(``blk_rc = rt << 16 | ct``, the layout of
:class:`~gnn_tpu_torch.ops.spmm.StreamBlocks`): edge scores as dot
products of endpoint embeddings, without the full ``R x C`` matrix.

:func:`stream_sddmm` launches the hand-written CUDA kernel
``gnn_tpu_torch/csrc/stream_spmm.cu`` (``stream_sddmm_f32``) on CUDA
tensors and runs the plain version :func:`sddmm_reference` on CPU tensors.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from gnn_tpu_torch.ops.spmm import StreamBlocks, check_tensor

# kernel launches ("sddmm"); incremented only where the CUDA kernel is
# launched
launches: collections.Counter = collections.Counter()


def sddmm_reference(blk_rc, x: torch.Tensor, y: torch.Tensor,
                    bm: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version: gather each entry's row tile of ``x`` and
    column tile of ``y`` and multiply them (``bmm``)."""
    rc = blk_rc.long()
    x, y = x.float(), y.float()
    xs = x.reshape(-1, bm, x.shape[-1]).index_select(0, rc >> 16)
    ys = y.reshape(-1, bk, y.shape[-1]).index_select(0, rc & 0xFFFF)
    return torch.bmm(xs, ys.transpose(1, 2))


def _kernel():
    from gnn_tpu_torch.ops import cuda_build
    fn = cuda_build.load("stream_spmm").stream_sddmm_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, p]
        fn.restype = i
    return fn


def stream_sddmm(blk_rc: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 bm: int = 128, bk: int = 128) -> torch.Tensor:
    """Per-tile scores ``[NB, bm, bk]`` of ``X @ Y^T`` on the stream's
    tiles; ``x`` [R, F] row embeddings, ``y`` [C, F] column embeddings
    (R a multiple of bm, C of bk). Output float32.

    CUDA tensors launch the hand-written kernel; CPU tensors take the
    plain version; any other device raises."""
    if (x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]
            or x.shape[0] % bm or y.shape[0] % bk):
        raise ValueError(f"stream_sddmm: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} do not make ({bm}, {bk}) tiles "
                         f"of one width")
    if x.device.type == "cpu":
        return sddmm_reference(blk_rc, x, y, bm, bk)
    if x.device.type != "cuda":
        raise ValueError(f"stream_sddmm: unsupported device {x.device}")
    dev = x.device
    x, y = x.float().contiguous(), y.float().contiguous()
    nb = blk_rc.shape[0]
    check_tensor("stream_sddmm", "x", x, torch.float32, dev)
    check_tensor("stream_sddmm", "y", y, torch.float32, dev)
    check_tensor("stream_sddmm", "blk_rc", blk_rc, torch.int32, dev, (nb,))
    out = torch.empty((nb, bm, bk), dtype=torch.float32, device=dev)
    err = _kernel()(blk_rc.data_ptr(), nb, x.data_ptr(), y.data_ptr(),
                    out.data_ptr(), x.shape[1], bm, bk,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_sddmm: CUDA launch failed "
                           f"(cudaError {err})")
    launches["sddmm"] += 1
    return out


def masked_edge_scores(stream: StreamBlocks, x, y) -> StreamBlocks:
    """Edge scores on the pattern of an existing SpMM stream: the dense
    tile scores times the pattern's 0/1 occupancy, in the same layout (a
    drop-in ``A`` for :func:`~gnn_tpu_torch.ops.spmm.stream_spmm`)."""
    scores = stream_sddmm(stream.blk_rc, x, y, stream.bm, stream.bk)
    mask = (stream.vals != 0).to(scores.dtype)
    return StreamBlocks(blk_rc=stream.blk_rc, vals=scores * mask,
                        nrows=stream.nrows, ncols=stream.ncols,
                        bm=stream.bm, bk=stream.bk, t_order=stream.t_order)
