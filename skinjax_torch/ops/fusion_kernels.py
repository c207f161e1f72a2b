"""The fusion stage of the serving path as four hand-written CUDA kernels.

Counterpart of ``skinjax/ops/pallas/fusion_kernels.py``. Every attention in
the fusion zoo runs at sequence length 1 and collapses to dense chains on
pooled (B, D) features (see ``skinjax_torch/ops/attention.py``); each kernel
runs one whole fusion block in one launch, with nothing written to device
memory between its matrix products.

  kernel                CUDA entry point (csrc/fusion_kernels.cu)  replaces (Pallas TPU kernel)
  seq1_attention        skinjax_seq1_attention                     fusion_kernels.py seq1_attention
  gated_residual_seq1   skinjax_gated_residual_seq1                fusion_kernels.py gated_residual_seq1
  metablock_film        skinjax_metablock_film                     fusion_kernels.py metablock_film
  mlp_head              skinjax_mlp_head                           fusion_kernels.py mlp_head

Each has a plain PyTorch twin (``*_plain``) with the same signature. A
wrapper dispatches on the device of its activation: a CPU tensor goes to the
twin, a CUDA tensor launches the kernel or raises. There is no fallback from
a failed build or launch to the twin.

Weights are fp32 in flax's (in, out) layout, ``y = x @ W + b``, so the JAX
kernels and these take the same arrays. Activations are float32 or bfloat16;
accumulation is fp32, and values round to the activation dtype exactly where
the Pallas kernels cast (``.astype(x.dtype)``).

What bounds the kernels on an H100, and what their design does about it, is
in the source note of ``csrc/fusion_kernels.cu``. ``seq1_attention_plan``,
``gated_residual_plan``, ``metablock_film_plan`` and ``mlp_head_plan`` choose
which of each kernel's two forms a call launches (a thread-block cluster at
the served widths, one block a tile elsewhere); the C entry points only
check the route.

``LAUNCHES`` counts kernel launches per kernel (a twin call is not counted),
so a caller can show that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from skinjax_torch.ops import check_tensor

LN_EPS = 1e-5  # torch nn.LayerNorm default

LAUNCHES: Dict[str, int] = {"seq1_attention": 0, "gated_residual_seq1": 0, "metablock_film": 0,
                            "mlp_head": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "skinjax_error_string": ([_I], ctypes.c_char_p),
    "skinjax_seq1_attention": ([_I] * 3 + [_P] * 6 + [_I, _I, _P], _I),
    "skinjax_seq1_cluster_count": ([_I] * 3 + [_P], _I),
    "skinjax_gated_residual_seq1": ([_I] * 3 + [_P] * 11 + [_I, _I, _P], _I),
    "skinjax_gated_residual_cluster_count": ([_I] * 3 + [_P], _I),
    "skinjax_metablock_film": ([_I] * 3 + [_P] * 11 + [_I] * 3 + [_P], _I),
    "skinjax_metablock_film_cluster_count": ([_I] * 5 + [_P], _I),
    "skinjax_mlp_head": ([_I] * 3 + [_P] * 12 + [_I] * 5 + [_P], _I),
    "skinjax_mlp_head_cluster_count": ([_I] * 6 + [_P], _I),
}
_ACT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM_BYTES = 227 * 1024  # the shared memory a block can use on an H100


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The kernels' shared library, built with nvcc on first use (raises if
    the build fails)."""
    from skinjax_torch.ops import build

    return build.load("fusion_kernels", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain twins (the reference for the kernels, and the CPU path)
# ---------------------------------------------------------------------------


def _ln(x, gamma, beta):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * gamma + beta


def seq1_attention_plain(kv, wv, bv, wo, bo):
    v = kv.float() @ wv + bv
    return (v.to(kv.dtype).float() @ wo + bo).to(kv.dtype)


def gated_residual_seq1_plain(q, kv, wv, bv, wo, bo, wg, bg, gamma, beta):
    qf = q.float()
    v = kv.float() @ wv + bv
    attn = v.to(kv.dtype).float() @ wo + bo
    gate = torch.sigmoid(qf @ wg + bg)
    return _ln(gate * attn + (1.0 - gate) * qf, gamma, beta).to(q.dtype)


def metablock_film_plain(v, u, wf, bf, gf, hf, wg, bg, gg, hg):
    uf = u.float()
    t1 = _ln(uf @ wf + bf, gf, hf)
    t2 = _ln(uf @ wg + bg, gg, hg)
    return torch.sigmoid(torch.tanh(v.float() * t1) + t2).to(v.dtype)


def mlp_head_plain(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3):
    h = torch.relu(_ln(x.float() @ w1 + b1, g1, h1))
    h = torch.relu(_ln(h.to(x.dtype).float() @ w2 + b2, g2, h2))
    return (h.to(x.dtype).float() @ w3 + b3).to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"fusion kernels take CPU or CUDA tensors, got {x.device}")
    return False


def _check_act(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"{name} has dtype {x.dtype}; the kernels take {_ACT_DTYPES}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be (B, D), got shape {tuple(x.shape)}")


def _launch(kernel: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = library().skinjax_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def _smem_check(kernel: str, floats_per_row: int) -> None:
    if 4 * 4 * floats_per_row > _MAX_SMEM_BYTES:
        raise ValueError(f"{kernel}: widths too large for one block's shared memory")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _cluster_rows(B: int, largest: int) -> int:
    """Rows a cluster tile: 1 at B = 1, 8 up to B = 8, else ``largest``."""
    return 1 if B <= 1 else 8 if B <= 8 else largest


def _d_cluster_width(D: int) -> bool:
    """Widths K1's and K2's cluster kernels take: D a multiple of 64 up to
    512 (D / 32 CTAs of 32 columns, at most 16)."""
    return D % 64 == 0 and 64 <= D <= 512


def seq1_attention_plan(B: int, D: int, aligned: bool = True, clusters=None) -> dict:
    """K1's route, chosen here only (the C entry point checks it): where D
    is a multiple of 64 up to 512, both weights allow 16-byte copies
    (``aligned``) and the card holds at least one such cluster
    (``clusters(rows)``, the count for ``rows`` rows a tile; None: assumed),
    ``seq1_cluster_kernel`` on clusters of D / 32 CTAs (32 output columns
    each), one cluster per tile of ``rows`` rows (1 at B = 1, 8 up to B = 8,
    else 32), so that each weight element is read once per call up to
    B = 32; else ``seq1_attention_kernel``, one block per tile of 1 (B < 4)
    or 4 rows."""
    if _d_cluster_width(D) and aligned:
        rows = _cluster_rows(B, 32)
        if clusters is None or clusters(rows) >= 1:
            return dict(kernel="seq1_cluster_kernel", cluster=D // 32, rows=rows)
    return dict(kernel="seq1_attention_kernel", cluster=1, rows=1 if B < 4 else 4)


def gated_residual_plan(B: int, D: int, aligned: bool = True, clusters=None) -> dict:
    """K2's route, as K1's: where D is a multiple of 64 up to 512, the three
    weights allow 16-byte copies and the card holds such a cluster,
    ``gated_residual_cluster_kernel`` on clusters of D / 32 CTAs (32 columns
    of all three products each) per tile of 1, 8 or 16 rows (q's rows beside
    kv's leave no room for 32); else ``gated_residual_kernel``, one block per
    tile of 1 (B < 4) or 4 rows."""
    if _d_cluster_width(D) and aligned:
        rows = _cluster_rows(B, 16)
        if clusters is None or clusters(rows) >= 1:
            return dict(kernel="gated_residual_cluster_kernel", cluster=D // 32, rows=rows)
    return dict(kernel="gated_residual_kernel", cluster=1, rows=1 if B < 4 else 4)


def film_cluster_ranks(Du: int, Vd: int) -> int:
    """The CTAs of K4's cluster at these widths: Vd / W for the narrowest W of
    32, 64 and 128 columns of each modulator that makes at most 16 CTAs, with
    Du a multiple of 128 up to 512; 0 where the cluster route does not take
    them (Vd 2048: 16 × 128, 768: 12 × 64, 512: 16 × 32)."""
    if Du % 128 or not 128 <= Du <= 512:
        return 0
    return next((Vd // w for w in (32, 64, 128) if Vd % w == 0 and Vd // w <= 16), 0)


def metablock_film_plan(B: int, Du: int, Vd: int, aligned: bool = True, clusters=None) -> dict:
    """K4's route, as K1's: where ``film_cluster_ranks`` takes the widths,
    both weights allow 16-byte copies and the card holds such a cluster,
    ``metablock_film_cluster_kernel`` on clusters of that many CTAs per tile
    of 1, 8 or 32 rows, each weight element read once per call up to B = 32;
    else ``metablock_film_kernel``, one block per tile of 1 (B < 4) or 4
    rows."""
    ranks = film_cluster_ranks(Du, Vd)
    if ranks and aligned:
        rows = _cluster_rows(B, 32)
        if clusters is None or clusters(rows) >= 1:
            return dict(kernel="metablock_film_cluster_kernel", cluster=ranks, rows=rows)
    return dict(kernel="metablock_film_kernel", cluster=1, rows=1 if B < 4 else 4)


# csrc/fusion_kernels.cu's K3 cluster kernel: K4's ring (4 stages of 8192
# floats), 32 columns of fc1 and 16 of fc2 a CTA, fc_out's columns (N3) up to
# 32, its parameters' slices (b1, g1, h1b; b2, g2, h2b; b3; 16 rows of W3)
_RING_FLOATS = 4 * 8192
_HEAD_MAX_OUT = 32
_HEAD_PARAMS = 3 * 32 + 3 * 16 + _HEAD_MAX_OUT + 16 * _HEAD_MAX_OUT


def mlp_head_cluster_smem_floats(K1: int, N1: int, rows: int) -> int:
    """The shared memory of K3's cluster kernel in floats, as
    ``mlp_head_cluster_smem_floats`` in ``csrc/fusion_kernels.cu`` computes
    it: the ring, the tile's rows (x, then h1) at stride max(K1, N1) + 4, the
    CTA's sums and its columns of h1, its parameters, the row statistics."""
    return _RING_FLOATS + rows * (max(K1, N1) + 4) + 2 * rows * 32 + _HEAD_PARAMS + 20 * rows


def _head_cluster_width(K1: int, N1: int, N2: int, N3: int) -> bool:
    """Widths K3's cluster kernel takes: N1 a multiple of 64 up to 512, N2 =
    N1 / 2, N3 up to 32, K1 a multiple of 32 at which a tile of 8 rows fits
    in a block's shared memory."""
    return (_d_cluster_width(N1) and 2 * N2 == N1 and 1 <= N3 <= _HEAD_MAX_OUT and K1 >= 32
            and K1 % 32 == 0 and 4 * mlp_head_cluster_smem_floats(K1, N1, 8) <= _MAX_SMEM_BYTES)


def mlp_head_plan(B: int, K1: int, N1: int, N2: int, N3: int, aligned: bool = True,
                  clusters=None) -> dict:
    """K3's route, as K1's: where ``_head_cluster_width`` takes the widths,
    W1 and W2 allow 16-byte copies and the card holds such a cluster,
    ``mlp_head_cluster_kernel`` on clusters of N1 / 32 CTAs per tile of 1
    (B = 1), 8 (up to B = 8) or else the most of 8, 16 and 32 rows whose x
    fits beside the ring (16 at K1 = 1024, 8 at 2048), each weight element
    read once per call at every batch a tile covers; else
    ``mlp_head_kernel``, one block per tile of 1 (B < 4) or 4 rows."""
    if _head_cluster_width(K1, N1, N2, N3) and aligned:
        largest = max(r for r in (8, 16, 32)
                      if 4 * mlp_head_cluster_smem_floats(K1, N1, r) <= _MAX_SMEM_BYTES)
        rows = _cluster_rows(B, largest)
        if clusters is None or clusters(rows) >= 1:
            return dict(kernel="mlp_head_cluster_kernel", cluster=N1 // 32, rows=rows)
    return dict(kernel="mlp_head_kernel", cluster=1, rows=1 if B < 4 else 4)


@functools.lru_cache(maxsize=None)
def _cluster_count(kernel: str, device_index: int, *args) -> int:
    """``skinjax_<kernel>_cluster_count``: how many of the kernel's clusters
    the card holds at once, as CUDA's occupancy query gives it; asked once
    a shape."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(library(), f"skinjax_{kernel}_cluster_count")(*args, ctypes.byref(count))
    if err != 0:
        msg = library().skinjax_error_string(err).decode()
        raise RuntimeError(f"{kernel}: the cluster query failed: CUDA error {err} ({msg})")
    return count.value


def seq1_cluster_count(device_index: int, bf16: bool, D: int, rows: int) -> int:
    """How many of K1's clusters (width D, ``rows`` rows a tile) the card
    holds at once."""
    return _cluster_count("seq1", device_index, int(bf16), rows, D)


def gated_residual_cluster_count(device_index: int, bf16: bool, D: int, rows: int) -> int:
    """How many of K2's clusters (width D, ``rows`` rows a tile) the card
    holds at once."""
    return _cluster_count("gated_residual", device_index, int(bf16), rows, D)


def metablock_film_cluster_count(device_index: int, bf16: bool, Du: int, Vd: int,
                                 rows: int) -> int:
    """How many of K4's clusters (widths Du, Vd, ``rows`` rows a tile) the
    card holds at once."""
    return _cluster_count("metablock_film", device_index, int(bf16), rows,
                          film_cluster_ranks(Du, Vd), Du, Vd)


def mlp_head_cluster_count(device_index: int, bf16: bool, K1: int, N1: int, N2: int, N3: int,
                           rows: int) -> int:
    """How many of K3's clusters (widths K1 → N1 → N2 → N3, ``rows`` rows a
    tile) the card holds at once."""
    return _cluster_count("mlp_head", device_index, int(bf16), rows, K1, N1, N2, N3)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def seq1_attention_call_plan(kv, wv, wo) -> dict:
    """seq1_attention_plan for a CUDA call on these tensors."""
    B, D = kv.shape
    return seq1_attention_plan(B, D, _aligned(wv, wo), functools.partial(
        seq1_cluster_count, kv.device.index, kv.dtype == torch.bfloat16, D))


def gated_residual_call_plan(q, wv, wo, wg) -> dict:
    """gated_residual_plan for a CUDA call on these tensors."""
    B, D = q.shape
    return gated_residual_plan(B, D, _aligned(wv, wo, wg), functools.partial(
        gated_residual_cluster_count, q.device.index, q.dtype == torch.bfloat16, D))


def metablock_film_call_plan(v, u, wf, wg) -> dict:
    """metablock_film_plan for a CUDA call on these tensors."""
    B, Vd = v.shape
    Du = u.shape[1]
    return metablock_film_plan(B, Du, Vd, _aligned(wf, wg), functools.partial(
        metablock_film_cluster_count, v.device.index, v.dtype == torch.bfloat16, Du, Vd))


def mlp_head_call_plan(x, w1, w2, w3) -> dict:
    """mlp_head_plan for a CUDA call on these tensors."""
    B, K1 = x.shape
    N1, N2, N3 = w1.shape[1], w2.shape[1], w3.shape[1]
    return mlp_head_plan(B, K1, N1, N2, N3, _aligned(w1, w2), functools.partial(
        mlp_head_cluster_count, x.device.index, x.dtype == torch.bfloat16, K1, N1, N2, N3))


def seq1_attention(kv, wv, bv, wo, bo):
    """(B, D) -> (B, D): the exact seq-1 MHA output, ``(kv@Wv+bv)@Wo+bo``."""
    if _on_cpu(kv):
        return seq1_attention_plain(kv, wv, bv, wo, bo)
    _check_act("kv", kv)
    B, D = kv.shape
    f32, dev = torch.float32, kv.device
    check_tensor("kv", kv, (B, D), kv.dtype, dev)
    for nm, t, shape in (("wv", wv, (D, D)), ("bv", bv, (D,)),
                         ("wo", wo, (D, D)), ("bo", bo, (D,))):
        check_tensor(nm, t, shape, f32, dev)
    plan = seq1_attention_call_plan(kv, wv, wo)
    if plan["kernel"] == "seq1_attention_kernel":
        _smem_check("seq1_attention", 2 * D)
    out = torch.empty_like(kv)
    if B == 0:
        return out
    _launch(
        "seq1_attention", library().skinjax_seq1_attention,
        int(kv.dtype == torch.bfloat16), int(plan["kernel"] == "seq1_cluster_kernel"),
        plan["rows"], kv.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), out.data_ptr(), B, D, _stream(dev),
    )
    return out


def gated_residual_seq1(q, kv, wv, bv, wo, bo, wg, bg, gamma, beta):
    """Full GatedAlteredResidualBlock at seq-1 (inference, dropout off):
    ``LN(g*attn + (1-g)*q)`` with ``g = σ(q@Wg+bg)`` and ``attn`` = seq1_attention(kv)."""
    if _on_cpu(q):
        return gated_residual_seq1_plain(q, kv, wv, bv, wo, bo, wg, bg, gamma, beta)
    _check_act("q", q)
    B, D = q.shape
    f32, dev = torch.float32, q.device
    check_tensor("q", q, (B, D), q.dtype, dev)
    check_tensor("kv", kv, (B, D), q.dtype, dev)
    for nm, t in (("wv", wv), ("wo", wo), ("wg", wg)):
        check_tensor(nm, t, (D, D), f32, dev)
    for nm, t in (("bv", bv), ("bo", bo), ("bg", bg), ("gamma", gamma), ("beta", beta)):
        check_tensor(nm, t, (D,), f32, dev)
    plan = gated_residual_call_plan(q, wv, wo, wg)
    if plan["kernel"] == "gated_residual_kernel":
        _smem_check("gated_residual_seq1", 4 * D)
    out = torch.empty_like(q)
    if B == 0:
        return out
    _launch(
        "gated_residual_seq1", library().skinjax_gated_residual_seq1,
        int(q.dtype == torch.bfloat16), int(plan["kernel"] == "gated_residual_cluster_kernel"),
        plan["rows"], q.data_ptr(), kv.data_ptr(), wv.data_ptr(),
        bv.data_ptr(), wo.data_ptr(), bo.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), B, D, _stream(dev),
    )
    return out


def metablock_film(v, u, wf, bf, gf, hf, wg, bg, gg, hg):
    """MetaBlock FiLM (inference): ``σ(tanh(v·LN(u@Wf+bf)) + LN(u@Wg+bg))``,
    v (B, Vd) and u (B, Du) of one activation dtype, weights (Du, Vd)."""
    if _on_cpu(v):
        return metablock_film_plain(v, u, wf, bf, gf, hf, wg, bg, gg, hg)
    _check_act("v", v)
    _check_act("u", u)
    B, Vd = v.shape
    Du = u.shape[1]
    f32, dev = torch.float32, v.device
    check_tensor("v", v, (B, Vd), v.dtype, dev)
    check_tensor("u", u, (B, Du), v.dtype, dev)
    for nm, t in (("wf", wf), ("wg", wg)):
        check_tensor(nm, t, (Du, Vd), f32, dev)
    for nm, t in (("bf", bf), ("gf", gf), ("hf", hf), ("bg", bg), ("gg", gg), ("hg", hg)):
        check_tensor(nm, t, (Vd,), f32, dev)
    plan = metablock_film_call_plan(v, u, wf, wg)
    cluster = plan["cluster"] if plan["kernel"] == "metablock_film_cluster_kernel" else 0
    if not cluster:
        _smem_check("metablock_film", Du + 2 * Vd)
    out = torch.empty_like(v)
    if B == 0:
        return out
    _launch(
        "metablock_film", library().skinjax_metablock_film,
        int(v.dtype == torch.bfloat16), cluster, plan["rows"], v.data_ptr(), u.data_ptr(),
        wf.data_ptr(), bf.data_ptr(), gf.data_ptr(), hf.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        gg.data_ptr(), hg.data_ptr(),
        out.data_ptr(), B, Du, Vd, _stream(dev),
    )
    return out


def mlp_head(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3):
    """Dense→LN→ReLU→Dense→LN→ReLU→Dense as one kernel (dropout off)."""
    if _on_cpu(x):
        return mlp_head_plain(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3)
    _check_act("x", x)
    B, K1 = x.shape
    N1, N2, N3 = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    f32, dev = torch.float32, x.device
    check_tensor("x", x, (B, K1), x.dtype, dev)
    for nm, t, shape in (
        ("w1", w1, (K1, N1)), ("b1", b1, (N1,)), ("g1", g1, (N1,)), ("h1", h1, (N1,)),
        ("w2", w2, (N1, N2)), ("b2", b2, (N2,)), ("g2", g2, (N2,)), ("h2", h2, (N2,)),
        ("w3", w3, (N2, N3)), ("b3", b3, (N3,)),
    ):
        check_tensor(nm, t, shape, f32, dev)
    plan = mlp_head_call_plan(x, w1, w2, w3)
    if plan["kernel"] == "mlp_head_kernel":
        _smem_check("mlp_head", K1 + N1 + N2 + N3)
    out = torch.empty((B, N3), dtype=x.dtype, device=dev)
    if B == 0:
        return out
    _launch(
        "mlp_head", library().skinjax_mlp_head,
        int(x.dtype == torch.bfloat16), int(plan["kernel"] == "mlp_head_cluster_kernel"),
        plan["rows"], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        g1.data_ptr(), h1.data_ptr(), w2.data_ptr(), b2.data_ptr(), g2.data_ptr(),
        h2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        B, K1, N1, N2, N3, _stream(dev),
    )
    return out
