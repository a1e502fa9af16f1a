"""int8 x int8 -> int32 conv and matmul with a fused dequant epilogue (kernel K1).

Port of alignq_tpu/kernels/qmatmul.py, and of the int8 convs that the JAX
serving graph leaves to XLA (alignq_tpu/kernels/infer.py _int8_conv_acc):
PyTorch has no int8 conv on CUDA. On a CUDA tensor the wrappers launch
an implicit-GEMM NHWC conv on the s8 tensor cores that reads the codes in
place, in one of four forms that the planner (`k1_plan`) chooses by a
written rule over the shape: csrc/qmatmul_sm90.cu (`wgmma` m64nNk32,
TMA-fed weight chunks, tiles of 64-256 output rows) for every 3x3 and 1x1
conv over C % 32 == 0 channels to N8 % 64 == 0 columns (`sm90_plan`);
csrc/qmatmul_sm90p.cu (`wgmma` on image planes laid out in shared memory
with the halo zero, from rows brought by bulk copies) for the 3x3s at
stride 1 and 2 over 16 or 32 channels to 16 or 32 columns where
`plane_takes` gives it them (`plane_plan`: ResNet-20/56's first two
stages, DenseNet-40's first growth conv);
csrc/qmatmul_sm90n.cu (`wgmma` at N = 16-64, A and B by descriptors, the
weight resident) for the narrower stride-1 3x3s and 1x1s over C % 16 == 0
channels where `narrow_takes` gives it them (`narrow_plan`);
csrc/qmatmul.cu (`mma.sync` m16n8k32) for every other shape. The CIFAR
nets' first conv, from the f32 image, has a kernel of its own
(kernels/first_conv.py).
The forms share their epilogue code (csrc/k1_epilogue.cuh) and agree bit
for bit. On a CPU tensor the wrappers run the plain PyTorch version
beside them, which the tests hold against the JAX reference.

The conv entry points are `int8_conv_packed` (int32, f32 or a stage
buffer's int8 requant epilogue) and `int8_conv_codes` (act codes, relu'd
or not) on NHWC int8 codes and a weight laid out once by
`pack_conv_weights`. The GEMM entry points (`int8_matmul_dequant`,
`int8_matmul_packed`, `int8_matmul_codes`, `int8_matmul_int32`) run through
the same kernel, as a 1x1 stride-1 conv over the (1, 1, M, Kp) view of x.
K1's codes epilogue maps the accumulators straight to int8 act codes (the
fused form of K2, csrc/act_codes.cuh), so the f32 (M, N) tensor is never
stored. `conv_plan` chooses each launch's tiling.

The plain conv gathers its taps (`gather_taps`) into an (M, K) matrix; the
kernel never does. Every gather of a CUDA tensor is counted under
TAP_GATHERS, so a run can show that the card's forward gathered nothing.

Column-parallel serving: a K1Weights cut to this rank's slice of N over
a mesh's model axis (shard_k1weights; dist/sharding.py shard_operands)
makes every entry point gather its output's channels over that axis,
the ranks' slices in rank order (int32, f32 or int8 alike), so the
caller sees the whole output. Each rank's K1 writes its slice only.

Epilogue `acc * scale + bias` is one f32 rounding: `__fmaf_rn` in CUDA,
`fma_f32` (float64 evaluation, rounded once to f32) in the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import weakref
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from alignq_tpu_torch.dist.collectives import gather_slices
from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.quantize import act_codes, act_table, int_bin_codes
from alignq_tpu_torch.quant.cdf import erf_grid_boundaries, fma_f32

K_MULT = 32  # depth of one m16n8k32 int8 MMA: K is zero-padded to it
N_MULT = 8  # width of one MMA n-tile
C_MULT = 4  # a conv's input channels are zero-padded to it: one MMA k-word
N_MAX = 256  # widest N block one CTA takes (8 warps of 32 columns)
SMEM_BUDGET = 110 * 1024  # bytes a CTA may take, so that two share an SM
K_CHUNK = 128  # K bytes a stage carries where a 1x1 weight does not fit
KERNEL = "int8_matmul_dequant"  # launch-counter key of every launch
# and of each family of epilogue modes: "int8_matmul_dequant:codes" etc.
_MODE = {"int32": 0, "f32": 1, "relu": 2, "poly": 3, "erf": 4, "bins": 5, "bins_int": 6, "requant": 7}
_FAMILY = {"int32": "int32", "f32": "f32", "relu": "f32", "requant": "requant"}
CODES = KERNEL + ":codes"
F32 = KERNEL + ":f32"
REQUANT = KERNEL + ":requant"
MODE = KERNEL + ":mode:{}"  # and of each epilogue mode: MODE.format("poly")
FORM = KERNEL + ":ks{}"  # and of each kernel size: FORM.format(7) the ImageNet stem, 5 the digit convs
SM90 = FORM.format("sm90")  # and of every launch of the Hopper form (csrc/qmatmul_sm90.cu)
TAP_GATHERS = "gather_taps:cuda"  # counter key of tap gathers of CUDA tensors


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_out_hw(h: int, w: int, ksize: int, stride: int, padding: int):
    return (h + 2 * padding - ksize) // stride + 1, (w + 2 * padding - ksize) // stride + 1


def gather_taps(
    x: torch.Tensor, ksize: int, stride: int = 1, padding: int = 0, k_mult: int = 1
) -> torch.Tensor:
    """The taps of a ksize x ksize conv over NHWC `x`, as the (B*Ho*Wo, K)
    matrix whose columns run (dy, dx, c) like an HWIO kernel reshaped to
    (ksize*ksize*C, Cout); K is zero-padded to a multiple of k_mult. The
    plain convs' layout; K1 reads x in place instead."""
    if x.is_cuda:
        _build.launches[TAP_GATHERS] += 1
    b, h, w, c = x.shape
    if padding:
        x = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    ho, wo = conv_out_hw(h, w, ksize, stride, padding)
    taps = [
        x[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    k = ksize * ksize * c
    if _round_up(k, k_mult) > k:
        taps.append(x.new_zeros((b, ho, wo, _round_up(k, k_mult) - k)))
    return torch.cat(taps, dim=-1).reshape(b * ho * wo, -1)


def kernel_matrix(kernel_hwio: torch.Tensor, k_mult: int = 1) -> torch.Tensor:
    """HWIO kernel as the (K, Cout) matrix matching gather_taps' columns."""
    kh, kw, cin, cout = kernel_hwio.shape
    k = kh * kw * cin
    mat = kernel_hwio.reshape(k, cout)
    return torch.nn.functional.pad(mat, (0, 0, 0, _round_up(k, k_mult) - k))


def int8_matmul_int32_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain (M, K) @ (K, N) -> int32. float64 is exact here: every
    product and partial sum is an integer below 2^53."""
    return (x.double() @ w.double()).to(torch.int32)


def int8_matmul_dequant_reference(x, w, scale, bias=None, relu=False):
    """Plain y = relu?((x @ w) * scale + bias), the epilogue rounded once."""
    acc = int8_matmul_int32_reference(x, w).float()
    y = fma_f32(acc, scale.reshape(1, -1), 0.0 if bias is None else bias.reshape(1, -1))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y


def _lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_conv_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, p, p, p, i, i, p]
        lib.k1_conv_launch.restype = i
        lib.k1_plan_ints.restype = i
        if lib.k1_plan_ints() != len(ConvPlan._fields):
            raise RuntimeError("csrc/qmatmul.cu's Plan does not match ConvPlan")
        lib._argtypes_set = True
    return lib


class K1Weights(NamedTuple):
    """A (K, N) int8 weight and its epilogue, laid out once as K1 takes
    them: wt is W^T, (N8, Kp) int8 zero-padded (the MMA's column-major B
    operand); scale and bias are (N8,) f32, zero-padded; n is the true N.
    As a conv weight (pack_conv_weights), K runs (dy, dx, c) over ksize x
    ksize taps of cin channels (the input's channels zero-padded to a
    multiple of 4); a GEMM weight is a 1x1 conv over cin = Kp channels.
    shard: the model axis where these are this rank's contiguous slice of
    a column-parallel weight's N (shard_k1weights); the entry points then
    gather the output's channels over it."""

    wt: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    n: int
    ksize: int
    cin: int
    shard: Optional[Any] = None


def pack_k1_weights(w: torch.Tensor, scale=None, bias=None) -> K1Weights:
    """Lay out w (K, N) int8 and its (N,) f32 scale/bias (None: 0) for K1."""
    k, n = w.shape
    kp, np_ = _round_up(k, K_MULT), _round_up(n, N_MULT)
    wt = torch.nn.functional.pad(w.t(), (0, kp - k, 0, np_ - n)).contiguous()

    def vec(v):
        v = torch.zeros(n, device=w.device) if v is None else v.to(torch.float32)
        return torch.nn.functional.pad(v, (0, np_ - n)).contiguous()

    return K1Weights(wt, vec(scale), vec(bias), n, 1, kp)


def pack_conv_weights(kernel_hwio: torch.Tensor, scale=None, bias=None) -> K1Weights:
    """Lay out an HWIO int8 conv kernel (ksize, ksize, Cin, N) and its (N,)
    f32 scale/bias for K1's conv form: Cin zero-padded to a multiple of 4
    (the stem's 3 -> 4, so that each 4-byte MMA k-word is one tap of one
    pixel), then kernel_matrix's (dy, dx, c) columns."""
    kh, kw, cin, _ = kernel_hwio.shape
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}x{kw}")
    cp = _round_up(cin, C_MULT)
    k = torch.nn.functional.pad(kernel_hwio, (0, 0, 0, cp - cin))
    return pack_k1_weights(kernel_matrix(k), scale, bias)._replace(ksize=kh, cin=cp)


def shard_k1weights(op: K1Weights, axis) -> K1Weights:
    """This rank's contiguous slice of a packed weight's N over the model
    axis (rows of wt, scale and bias), padded to its own N8; the weight
    itself where N does not divide by the axis size."""
    if axis is None or axis.size == 1 or op.n % axis.size:
        return op
    w = op.n // axis.size
    rows = slice(axis.rank * w, (axis.rank + 1) * w)
    pad = _round_up(w, N_MULT) - w

    def part(t):
        t = t[rows]
        return torch.nn.functional.pad(t, (0, 0, 0, pad) if t.ndim == 2 else (0, pad)).contiguous()

    return op._replace(wt=part(op.wt), scale=part(op.scale), bias=part(op.bias), n=w, shard=axis)


def _gather_n(y: torch.Tensor, op: K1Weights) -> torch.Tensor:
    """A column-parallel weight's whole output from this rank's slice of
    its last dim (the model ranks' slices in rank order)."""
    return y if op.shard is None else gather_slices(y, op.shard, -1)


class ActMap(NamedTuple):
    """An act site's code map as K1's codes epilogue takes it. impl: 'poly'
    | 'erf' | 'bins' | 'bins_int'; g: the grid's largest code. bins: bnd,
    the (g,) f32 erf-grid boundaries. bins_int: sgn (N8,) and t1, t2
    (g, N8) int32 per-column cutpoints (kernels/infer.py
    act_int_cutpoints), zero-padded to the packed weight's width, and n,
    their true width. Fields a map does not use are None. relu: the codes
    take max(code, 0)."""

    impl: str
    g: int
    bnd: Optional[torch.Tensor] = None
    sgn: Optional[torch.Tensor] = None
    t1: Optional[torch.Tensor] = None
    t2: Optional[torch.Tensor] = None
    relu: bool = False
    n: Optional[int] = None


@functools.lru_cache(maxsize=None)
def act_map(impl: str, g: int, device: torch.device, relu: bool = False) -> ActMap:
    """The poly, erf or bins map of grid g on a device (with relu: the
    codes' max(code, 0)), laid out once per process (bins_int, which is per
    site, is pack_act_cutpoints')."""
    if impl not in ("poly", "erf", "bins"):
        raise ValueError(f"unknown act impl {impl!r}")
    if impl == "bins":
        if g > 15:
            raise ValueError("bins impl is for the A4/A2 grids (A8 g=127: use poly)")
        return ActMap(impl, g, bnd=torch.from_numpy(erf_grid_boundaries(g)).to(device), relu=relu)
    return ActMap(impl, g, relu=relu)


def pack_act_cutpoints(cut, n8: int) -> ActMap:
    """A site's bins_int cutpoints {'sgn': (N,), 't1', 't2': (g, N)} int32
    as an ActMap, zero-padded to n8 columns."""
    n = cut["sgn"].shape[0]

    def pad(t):
        return torch.nn.functional.pad(t.to(torch.int32), (0, n8 - n)).contiguous()

    return ActMap("bins_int", int(cut["t1"].shape[0]), sgn=pad(cut["sgn"]), t1=pad(cut["t1"]), t2=pad(cut["t2"]),
                  n=n)


def shard_act_cutpoints(act: ActMap, axis) -> ActMap:
    """A bins_int site's cutpoints cut as its conv's weight is by
    shard_k1weights (this rank's contiguous slice of the n true columns,
    padded to the slice's N8); the map itself where n does not divide by
    the axis size, or where it has no columns (poly, erf, bins)."""
    if act.n is None or axis is None or axis.size == 1 or act.n % axis.size:
        return act
    w = act.n // axis.size
    cols = slice(axis.rank * w, (axis.rank + 1) * w)
    cut = {"sgn": act.sgn[cols], "t1": act.t1[:, cols], "t2": act.t2[:, cols]}
    return pack_act_cutpoints(cut, _round_up(w, N_MULT))


class ConvPlan(NamedTuple):
    """One K1 launch's tiling, in the order of csrc/qmatmul.cu's Plan.

    A tile is TR x TW output pixels of one image; tiles run (b, ty, tx)
    over tiles_y x tiles_x a image. Its input band, HR x HC pixels (the
    halo included for ksize 3 and 7; the window's reach for the VALID 5x5;
    the strided sample for ksize 1), sits in
    shared memory at a pixel pitch P and a row pitch RP; a stage carries CC
    channels, KC bytes of K, n_chunks stages a tile (1 where the weight is
    resident: then CC = C, KC = Kp); the last stage KCL bytes of K. WP: the
    weight's row pitch in shared memory; vec: the cp.async size; then the
    shared-memory regions' bytes, the warps over M and N, the stage buffers
    in the ring (loads of n_stages - 1 steps in flight), and N's split into
    n_blocks blocks of NB columns (a grid dimension)."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    pad: int
    ksize: int
    N8: int
    Kp: int
    TR: int
    TW: int
    tiles_y: int
    tiles_x: int
    n_tiles: int
    HR: int
    HC: int
    P: int
    RP: int
    KC: int
    n_chunks: int
    CC: int
    KCL: int
    WP: int
    vec: int
    koff_bytes: int
    w_bytes: int
    a_bytes: int
    stage_bytes: int
    smem: int
    warps_m: int
    warps_n: int
    n_stages: int
    NB: int
    n_blocks: int


def _pixel_pitch(width: int, step: int) -> int:
    """Bytes a band pixel takes in shared memory. From 16 channels up, the
    4 lanes t of a fragment load read 16 bytes of one pixel and its 8 rows
    g are pixels `step` apart: (step * P / 4) % 8 == 4 puts them on the 8
    distinct groups of 4 banks. Under 16 (the stem), the lanes t read
    different taps, and a dense pitch keeps the fragment free of conflicts
    given _row_pitch."""
    p = _round_up(width, C_MULT)
    if width < 16:
        return p
    while (step * p // 4) % 8 != 4:
        p += 4
    return p


def _row_pitch(hc: int, p: int, width: int) -> int:
    """Bytes a band row takes: dense, but under 16 channels a pitch of 16
    mod 32 banks, so that the lower tap row falls on the other half."""
    rp = hc * p
    if width < 16:
        while (rp // 4) % 32 != 16:
            rp += 4
    return rp


def _band_bytes(hr: int, hc: int, width: int, step: int):
    """(P, RP, bytes) of a band of hr x hc pixels of `width` bytes."""
    p = _pixel_pitch(width, step)
    rp = _row_pitch(hc, p, width)
    return p, rp, _round_up(hr * rp, 16)


KSIZES = {3: 1, 1: 0, 7: 3, 5: 0}  # the kernel sizes K1 takes, each with its one padding (5: the digit net's VALID)


def _tile(ho: int, wo: int, bm: int, warps_m_max: int):
    """(TR, TW) of a tile of about bm output pixels: bands of whole output
    rows (TW the width rounded up to 8), TR*TW a multiple of 32; an image
    wider than bm (the GEMM view, the stem) in one-row tiles of one 32-row
    group a warp."""
    tw = _round_up(wo, 8)
    if tw >= bm:
        return 1, 32 * min(bm // 32, warps_m_max)
    return _round_up(min(max(bm // tw, 1), ho), 32 // math.gcd(tw, 32)), tw


def _streamed_tile(ho: int, wo: int, warps_m_max: int):
    """(TR, TW) of a tile where K streams: each warp keeps one 32-row group
    of accumulators over the chunks, so a tile holds at most warps_m_max
    groups. Bands of whole rows where one fits, else one-row tiles of as
    few groups as cover a row."""
    tw = _round_up(wo, 8)
    step = 32 // math.gcd(tw, 32)
    tr = min(32 * warps_m_max // tw // step * step, _round_up(ho, step))
    if tr == 0:
        return 1, 32 * min(warps_m_max, -(-wo // 32))
    return tr, tw


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int, kp: int) -> ConvPlan:
    """The tiling of one K1 launch over x (b, h, w, c) int8 and a packed
    weight (n8, kp): 3x3 pad 1, 1x1 pad 0, 7x7 pad 3 (the ImageNet stem) or
    5x5 pad 0 (the digit DANN's VALID convs: a band with no halo, its rows
    past the image zero-filled and never read by an output that lands),
    stride 1 or 2. N splits into the fewest blocks of at most N_MAX columns
    (fewer where a streamed 3x3 chunk of the weight would not fit). Tiles
    are bands of whole output rows of ~128 pixels where a block has <= 32
    columns and ~64 above (_tile). The weight is resident where the CTA
    fits SMEM_BUDGET with two stage buffers; else K streams, over tiles of
    at most one 32-row group a warp (_streamed_tile where the first tile
    has more): a 1x1 conv (the GEMM form) in
    chunks of K_CHUNK channels, a larger kernel in chunks of the most
    channels (a multiple of 32) that fit, each with its taps. Then as many
    stage buffers as fit, up to 4."""
    if KSIZES.get(ksize) != pad or stride not in (1, 2):
        raise ValueError(f"K1 takes 3x3 pad 1, 1x1 pad 0, 7x7 pad 3 or 5x5 pad 0 at stride 1 or 2, got {ksize}x{ksize} "
                         f"pad {pad} stride {stride}")
    if c % C_MULT or kp % K_MULT or n8 % N_MULT or n8 <= 0:
        raise ValueError(f"C={c}, Kp={kp}, N8={n8} out of K1's range")
    if kp != _round_up(ksize * ksize * c, K_MULT):
        raise ValueError(f"a packed depth of {kp} does not fit a {ksize}x{ksize} conv over {c} channels")
    ho, wo = conv_out_hw(h, w, ksize, stride, pad)
    if b * ho * wo >= 2**31:
        raise ValueError(f"{b * ho * wo} output rows: K1 indexes them with 32-bit ints")
    for nb_max in (N_MAX, 128, 64, 32):
        plan = _plan_n_blocks(b, h, w, c, ksize, stride, pad, n8, kp, ho, wo, nb_max)
        if plan is not None:
            return plan
    raise ValueError(f"a {ksize}x{ksize} conv over {c} channels to {n8} does not fit K1's shared memory")


def _plan_n_blocks(b, h, w, c, ksize, stride, pad, n8, kp, ho, wo, nb_max) -> Optional[ConvPlan]:
    """conv_plan with N in blocks of at most nb_max columns, or None where
    it does not fit."""
    n_blocks = -(-n8 // nb_max)
    nb = _round_up(-(-n8 // n_blocks), N_MULT)
    warps_n = -(-nb // 32)
    warps_m_max = max(1, 8 // warps_n)
    ps = stride if ksize > 1 else 1  # pixel step of one output pixel in the band
    taps = ksize * ksize

    def band(tr, tw, width):
        hr, hc = (tr - 1) * ps + ksize, (tw - 1) * ps + ksize
        return (hr, hc, *_band_bytes(hr, hc, width, ps))

    tr, tw = _tile(ho, wo, 128 if nb <= 32 else 64, warps_m_max)
    width = c if ksize > 1 else kp  # bytes a band pixel holds
    hr, hc, p, rp, a_bytes = band(tr, tw, width)
    kc, cc, n_chunks, kcl, wp = kp, c, 1, kp, kp + 16
    koff_bytes = _round_up(kp, 16) if ksize > 1 else 0
    w_bytes, stage = nb * wp, a_bytes
    loads = [c]
    if koff_bytes + w_bytes + 2 * stage > SMEM_BUDGET:
        if tr * tw > 32 * warps_m_max:
            tr, tw = _streamed_tile(ho, wo, warps_m_max)
        if ksize == 1:
            kc = cc = K_CHUNK
            n_chunks = -(-kp // kc)
            kcl = kp - (n_chunks - 1) * kc
            hr, hc, p, rp, a_bytes = band(tr, tw, kc)
            koff_bytes, wp = 0, kc + 16
            loads = [kc, c % kc or kc]
        else:
            def fits(cc_):
                kcl_ = _round_up(taps * (c - (-(-c // cc_) - 1) * cc_), K_MULT)
                return _round_up(taps * cc_ + kcl_, 16) + 2 * (band(tr, tw, cc_)[4] + nb * (taps * cc_ + 16)) \
                    <= SMEM_BUDGET

            cc = next((m for m in range(c // 32 * 32, 0, -32) if fits(m)), 0)
            if cc == 0:
                return None
            kc, n_chunks = taps * cc, -(-c // cc)
            ccl = c - (n_chunks - 1) * cc
            kcl = _round_up(taps * ccl, K_MULT)
            hr, hc, p, rp, a_bytes = band(tr, tw, cc)
            koff_bytes, wp = _round_up(kc + kcl, 16), kc + 16
            loads = [c, cc, ccl]
        w_bytes, stage = 0, a_bytes + nb * wp
    mgroups = tr * tw // 32
    warps_m = min(mgroups, warps_m_max)
    n_stages = next(n for n in (4, 3, 2) if koff_bytes + w_bytes + n * stage <= SMEM_BUDGET)
    smem = koff_bytes + w_bytes + n_stages * stage
    vec = next(v for v in (16, 8, 4) if all(s % v == 0 for s in (p, rp, *loads)))
    return ConvPlan(
        b, h, w, c, ho, wo, stride, pad, ksize, n8, kp, tr, tw, -(-ho // tr), -(-wo // tw),
        b * -(-ho // tr) * -(-wo // tw), hr, hc, p, rp, kc, n_chunks, cc, kcl, wp, vec,
        koff_bytes, w_bytes, a_bytes, stage, smem, warps_m, warps_n, n_stages, nb, n_blocks,
    )


# ---------------------------------------------------------- the Hopper form

SM90_SMEM = 227 * 1024  # dynamic shared memory an sm_90 block may take
SM90_MAX_STAGES = 6  # csrc/qmatmul_sm90.cu MAX_STAGES: the mbarriers' room
# channels a stage may carry, the first that divides C and whose ring of 2
# stages fits: a 3x3's K chunk is 576 or 288 bytes, a 1x1's 256 down to 32
# (fewer, larger stages ran faster on the card: PERF.md's K1 findings)
SM90_CC = {3: (64, 32), 1: (256, 128, 64, 32)}
# work items (tile, N block) a tile height must give for a launch to take
# it: half the H100's 132 SMs. Tiles of 256 rows ran fastest at batch 256
# and lost to 128 and 64 at the trunks' batches 4 and 3 (PERF.md, K1's
# Hopper form: chip_smoke.py --k1-ab)
SM90_MIN_ITEMS = 66


class Sm90Plan(NamedTuple):
    """One launch's plan in K1's Hopper form, in the order of
    csrc/qmatmul_sm90.cu's Plan.

    The M = B*Ho*Wo output rows, in (b, oy, ox) order, run in n_tiles tiles
    of TM = 64 * n_wg consecutive rows (n_wg warpgroups, one m64 wgmma tile
    each), N in n_blocks blocks of NB columns; a work item is (tile, N
    block), n_items of them. A stage carries CC channels of the input, K
    bytes KC (KCL in the last of the n_chunks chunks): the weight chunk in
    n_boxes TMA boxes of SWZ bytes of K by NB rows (w_bytes, swizzled SWZ),
    then the band (a_bytes): for a 3x3, HR rows of the zero-padded batch
    (Hp rows an image) by HC = W + 2 pixels at a pixel pitch P and a row
    pitch RP; for a 1x1, the tile's TM input pixels at P. koff_words: the
    3x3's k-word table; smem: the bytes the launch asks for."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    pad: int
    ksize: int
    N8: int
    Kp: int
    M: int
    TM: int
    n_tiles: int
    NB: int
    n_blocks: int
    n_items: int
    HR: int
    HC: int
    Hp: int
    P: int
    RP: int
    CC: int
    n_chunks: int
    KC: int
    KCL: int
    SWZ: int
    n_boxes: int
    w_bytes: int
    a_bytes: int
    stage_bytes: int
    n_stages: int
    koff_words: int
    smem: int
    n_wg: int


def _sm90_pitch(cc: int, step: int) -> int:
    """Bytes a band pixel takes: lane t of a fragment load reads 8 bytes
    of its row, rows g of a half warp are pixels `step` apart, so that
    (step * P) % 64 == 32 puts its 4 rows' 32 bytes on distinct banks."""
    p = cc
    while (step * p) % 64 != 32:
        p += 16
    return p


def _sm90_band_rows(b: int, ho: int, wo: int, hp: int, stride: int, tm: int) -> int:
    """The most rows of the zero-padded batch (hp rows an image) that one
    tile of tm consecutive output pixels reaches, less the kernel's."""
    m0 = np.arange(0, b * ho * wo, tm, dtype=np.int64)
    m1 = np.minimum(m0 + tm, b * ho * wo) - 1

    def row(m):
        return m // (ho * wo) * hp + m % (ho * wo) // wo * stride

    return int((row(m1) - row(m0)).max())


@functools.lru_cache(maxsize=None)
def sm90_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int,
              kp: int, n_wg: Optional[int] = None) -> Optional[Sm90Plan]:
    """The Hopper form's plan of one launch, or None where the form does
    not take the shape: a 3x3 pad 1 or 1x1 pad 0 conv at stride 1 or 2 over
    C % 32 == 0 channels to N8 % 64 == 0 columns (the weight unpadded in
    K). N blocks of 128 columns (64 where N8 is not a multiple of 128);
    tiles of 256 rows (4 warpgroups) where they give SM90_MIN_ITEMS work
    items or more, else of 128, else of 64: the most rows a tile that
    still spreads the launch over the card; K in chunks of the first of
    SM90_CC's channel counts that divides C and whose ring of 2 stages
    (each its weight columns and its band) fits SM90_SMEM; then as many
    stages as fit, up to 4. n_wg, where given, sets the warpgroups (tiles
    of 64 n_wg rows) instead."""
    if ksize not in (1, 3) or KSIZES[ksize] != pad or stride not in (1, 2):
        return None
    if c % 32 or n8 % 64 or kp != ksize * ksize * c:
        return None
    nb = 128 if n8 % 128 == 0 else 64
    fits = []
    for wgs in (4, 2, 1) if n_wg is None else (n_wg,):
        plan = next((p for cc in SM90_CC[ksize] if c % cc == 0
                     for p in [_sm90_layout(b, h, w, c, ksize, stride, pad, n8, cc, nb, wgs)] if p is not None), None)
        if plan is not None:
            fits.append(plan)
    return next((p for p in fits if p.n_items >= SM90_MIN_ITEMS), fits[-1] if fits else None)


def _sm90_layout(b, h, w, c, ksize, stride, pad, n8, cc, nb, n_wg) -> Optional[Sm90Plan]:
    """sm90_plan at a given chunk of cc channels, N block of nb columns and
    n_wg warpgroups, with as many stages as fit SM90_SMEM (up to 4), or
    None where 2 do not fit or the output has no rows."""
    ho, wo = conv_out_hw(h, w, ksize, stride, pad)
    m = b * ho * wo
    if m <= 0 or m >= 2**31:
        return None
    n_chunks = -(-c // cc)
    kc, kcl = ksize * ksize * cc, ksize * ksize * (c - (n_chunks - 1) * cc)
    swz = next(s for s in (128, 64, 32) if kc % s == 0)
    n_boxes = kc // swz
    w_bytes = n_boxes * nb * swz
    hp, hc = h + 2 * pad, w + 2 * pad
    p = _sm90_pitch(cc, stride if ksize > 1 else 1)
    koff_words = kc // 8 if ksize > 1 else 0
    fixed = 1024 + 8 * SM90_MAX_STAGES + 4 * koff_words  # the stages' alignment, the mbarriers, the table
    tm = 64 * n_wg
    if ksize > 1:
        hr = _sm90_band_rows(b, ho, wo, hp, stride, tm) + ksize
        rp = hc * p
    else:
        hr, rp = tm, p
    a_bytes = hr * rp
    stage = _round_up(w_bytes + a_bytes, 1024)
    n_stages = max((n for n in range(2, 5) if fixed + n * stage <= SM90_SMEM), default=0)
    if not n_stages:
        return None
    n_tiles = -(-m // tm)
    return Sm90Plan(
        b, h, w, c, ho, wo, stride, pad, ksize, n8, ksize * ksize * c, m, tm, n_tiles, nb, n8 // nb,
        n_tiles * (n8 // nb), hr, hc, hp, p, rp, cc, n_chunks, kc, kcl, swz, n_boxes, w_bytes, a_bytes, stage,
        n_stages, koff_words, fixed + n_stages * stage, n_wg,
    )


# ---------------------------------------------------- the narrow Hopper form

NARROW = FORM.format("sm90n")  # and of every launch of the narrow Hopper form (csrc/qmatmul_sm90n.cu)
NARROW_MAX_STAGES = 4  # csrc/qmatmul_sm90n.cu MAX_STAGES: the mbarriers' room


class NarrowPlan(NamedTuple):
    """One launch's plan in K1's narrow Hopper form, in the order of
    csrc/qmatmul_sm90n.cu's Plan.

    The kernel runs MP rows in n_tiles tiles of TM = 64 * MG * WM
    consecutive rows: a 1x1 conv's M = B*Ho*Wo output pixels, a 3x3's
    positions of the zero-padded batch (Hp = H + 2 rows of HC = W + 2 pixels
    an image; the halo's positions are computed and dropped). N runs in
    n_blocks blocks of NB (16, 32 or 64) columns (the last zero-padded past
    N8); a work item is (tile, N block). A CTA is n_wg = WM * WK
    warpgroups: WM over the rows, each holding MG m64 row groups, and WK
    over the tile's K steps. The weight's K runs in n_chunks chunks of CC
    channels (G groups of 16), KCP = 32 * steps bytes each (_narrow_k_order);
    the whole re-packed N block, KT = n_chunks * KCP bytes a row, is
    resident (w_bytes, in n_boxes TMA boxes of SWZ bytes of K by NB rows).
    A stage carries one chunk's band (a_bytes): group q of its NPIX pixels
    at q * GS + 16 i. The *_off fields place the shared-memory regions from
    the 1024-byte aligned weight; smem: the bytes the launch asks for."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    pad: int
    ksize: int
    N8: int
    Kp: int
    M: int
    MP: int
    TM: int
    n_tiles: int
    NB: int
    n_blocks: int
    n_items: int
    MG: int
    WM: int
    WK: int
    n_wg: int
    Hp: int
    HC: int
    NPIX: int
    GS: int
    CC: int
    G: int
    n_chunks: int
    KCP: int
    KT: int
    SWZ: int
    n_boxes: int
    w_bytes: int
    a_bytes: int
    stage_bytes: int
    n_stages: int
    steps: int
    stage_off: int
    acc_off: int
    sb_off: int
    tab_off: int
    bar_off: int
    smem: int


def _narrow_nb(n8: int):
    """(NB, n_blocks): one block of 16 or 32 columns where N8 fits, else
    blocks of 64 (wgmma's n of each)."""
    if n8 <= 32:
        return (16 if n8 <= 16 else 32), 1
    return 64, -(-n8 // 64)


def _mg_max(nb: int) -> int:
    """Row groups a warpgroup may hold: 32 accumulators a thread."""
    return max(1, 64 // nb)


def _narrow_steps(ksize: int, g: int) -> list:
    """A chunk's K steps of g groups of 16 channels, as (first, second):
    each 16 bytes of the step as (group, tap), None for zero columns: the
    group pairs (2j, 2j + 1) tap after tap, then the odd group's taps two at
    a time (its last tap against zeros)."""
    taps = ksize * ksize
    steps = [((2 * j, t), (2 * j + 1, t)) for j in range(g // 2) for t in range(taps)]
    if g % 2:
        steps += [((g - 1, t), (g - 1, t + 1) if t + 1 < taps else None) for t in range(0, taps, 2)]
    return steps


def _narrow_layout(b, h, w, c, ksize, stride, pad, n8, cc, mg, wm, wk) -> Optional[NarrowPlan]:
    """narrow_plan at a given chunk of cc channels and (MG, WM, WK), with
    as many stages as fit SM90_SMEM (up to 4), or None where 2 do not fit,
    the output has no rows or a warpgroup would have no K step."""
    ho, wo = conv_out_hw(h, w, ksize, stride, pad)
    m = b * ho * wo
    nb, n_blocks = _narrow_nb(n8)
    if m <= 0 or mg not in (1, _mg_max(nb)) or c % cc or cc % 16:
        return None
    hp, hc = (h + 2, w + 2) if ksize == 3 else (h, w)
    mp = b * hp * hc if ksize == 3 else m
    if mp >= 2**31:
        return None
    g = cc // 16
    steps = len(_narrow_steps(ksize, g))
    n_chunks = c // cc
    kcp = 32 * steps
    kt = n_chunks * kcp
    if n_chunks * steps < wk or 128 * wm * wk > 512:
        return None
    swz = next(s for s in (128, 64, 32) if kt % s == 0)
    w_bytes = nb * kt
    tm = 64 * mg * wm
    # the band: the tile's rows and the taps' reach past them, and a pixel
    # the zero columns' second half may read; odd, so that a copy's 16-byte
    # pieces of one pixel's groups fall on different banks
    npix = tm + (2 * hc + 2 if ksize == 3 else 0) + 1
    npix += 1 - npix % 2
    gs = 16 * npix
    a_bytes = g * gs
    stage_bytes = _round_up(a_bytes, 128)
    acc_bytes = wk * tm * (nb + 8) * 4  # each K share's int32 sums, rows padded (csrc acc_pitch)
    stage_off = _round_up(w_bytes, 128)
    fixed = 1024 + stage_off + acc_bytes + 8 * nb + 8 * steps + 8 * (NARROW_MAX_STAGES + 1)
    n_stages = max((n for n in range(2, NARROW_MAX_STAGES + 1) if fixed + n * stage_bytes <= SM90_SMEM), default=0)
    if not n_stages:
        return None
    acc_off = stage_off + n_stages * stage_bytes
    sb_off = acc_off + acc_bytes  # the N block's scales and biases, f32
    tab_off = sb_off + 8 * nb
    bar_off = tab_off + 8 * steps
    n_tiles = -(-mp // tm)
    return NarrowPlan(
        b, h, w, c, ho, wo, stride, pad, ksize, n8, _round_up(ksize * ksize * c, K_MULT), m, mp, tm, n_tiles, nb,
        n_blocks, n_tiles * n_blocks, mg, wm, wk, wm * wk, hp, hc, npix, gs, cc, g, n_chunks, kcp, kt, swz, kt // swz,
        w_bytes, a_bytes, stage_bytes, n_stages, steps, stage_off, acc_off, sb_off, tab_off, bar_off,
        1024 + bar_off + 8 * (NARROW_MAX_STAGES + 1),
    )


def narrow_options(n8: int) -> list:
    """The (MG, WM, WK) a narrow launch may take, tallest tiles first: MG at
    its most (256 rows a warpgroup at N = 16) on 2 or 1 warpgroups, then
    one m64 group a warpgroup on 2 or 1 warpgroups over rows, or on 2 or 4
    that split K."""
    mgm = _mg_max(_narrow_nb(n8)[0])
    return list(dict.fromkeys([(mgm, 2, 1), (mgm, 1, 1), (1, 2, 1), (1, 1, 1), (1, 1, 2), (1, 1, 4)]))


# Where chip_smoke.py --k1-ab timed both forms (PERF.md, K1's narrow form): a launch
# runs TILES_TALL 64-row tiles or more (ResNet-20's stage-1 conv at 2048 and
# 256, DenseNet-40's 32x32 stage at 256) on tall tiles, TILES_WIDE or more
# (its 16x16 stage at 256) on 2 warpgroups of 64 rows; fewer on 4
# warpgroups that split K where K has DEEP_STEPS steps or more (the 8x8
# stage, and every deep stage at batch 8); at SMALL_ITEMS work items or
# fewer (MobileNet-V2's and the transitions' 1x1s at batch 8) K split over
# 4 from 12 steps, over 2 from 2; else on 2 warpgroups of 64 rows.
TILES_TALL, TILES_WIDE, DEEP_STEPS, SMALL_ITEMS = 3000, 600, 48, 64
# The 1x1s whose N is over 64 columns (N blocks) and those to N8 % 16 != 0
# ran slower than mma.sync above these many output rows
BLOCKS_ROWS, ODD_N_ROWS = 4096, 8192


def _narrow_rows(b, h, w, ksize, stride, pad):
    """The rows the narrow form runs: a 3x3's padded positions, a 1x1's outputs."""
    ho, wo = conv_out_hw(h, w, ksize, stride, pad)
    return b * (h + 2) * (w + 2) if ksize == 3 else b * ho * wo


def _narrow_option(b, h, w, c, ksize, stride, pad, n8) -> tuple:
    """narrow_plan's (MG, WM, WK) by its rule: tall tiles (MG at its most)
    from TILES_TALL 64-row tiles (for a 3x3 under 10 K steps and a 1x1 to 16
    columns one warpgroup of them, else two; a 1x1 from 1,000), 2
    warpgroups of 64 rows from TILES_WIDE; under that K split over 4 where
    K has DEEP_STEPS steps or more, and at SMALL_ITEMS work items or fewer
    over 4 from 12 steps or 2 from 2; else 2 warpgroups of 64 rows."""
    tiles = -(-_narrow_rows(b, h, w, ksize, stride, pad) // 64)
    steps = _round_up(ksize * ksize * c, K_MULT) // 32
    nb, n_blocks = _narrow_nb(n8)
    mgm = _mg_max(nb)
    if tiles >= TILES_TALL or ksize == 1 and tiles >= 1000:
        return (mgm, 1, 1) if (ksize == 3 and steps < 10) or (ksize == 1 and nb == 16) else (mgm, 2, 1)
    if tiles >= TILES_WIDE:
        return 1, 2, 1
    if steps >= DEEP_STEPS:
        return 1, 1, 4
    if tiles * n_blocks <= SMALL_ITEMS:
        return 1, 1, 4 if steps >= 12 else 2 if steps >= 2 else 1
    return 1, 2, 1


def narrow_takes(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int) -> bool:
    """The planner's rule for the narrow form, among the shapes narrow_plan
    takes: every one but those chip_smoke.py --k1-ab measured slower than
    mma.sync by more than 3% (PERF.md, K1's narrow form): the 3x3s to more than 16
    columns (ResNet-20's block-3 conv1, 1.07x at 2048 and 1.15x at 256);
    the tall 3x3s of 10-15 K steps (DenseNet-40's 32x32 conv over 48
    channels at 256, 1.04x in f32); the 3x3s on TILES_WIDE tiles of
    DEEP_STEPS to 59 K steps (its 16x16 convs over 176-208 channels at
    256, 1.00-1.05x);
    the 1x1s to N blocks above BLOCKS_ROWS
    output rows (DenseNet-40's transitions at 256, 1.3-1.4x; MobileNet-V2's
    8x8 ones to 96, 1.15-1.2x), to N8 % 16 != 0 above ODD_N_ROWS
    (MobileNet-V2's 1x1s to 24 at 256, 1.07-1.3x) and to 16 columns on tall
    tiles (its 32x32 ones at 256, 1.04x)."""
    rows = _narrow_rows(b, h, w, ksize, stride, pad)
    tiles = -(-rows // 64)
    steps = _round_up(ksize * ksize * c, K_MULT) // 32
    if ksize == 3:
        return n8 <= 16 and not (tiles >= TILES_TALL and 10 <= steps < 16 or
                                 TILES_WIDE <= tiles < TILES_TALL and DEEP_STEPS <= steps < 60)
    if n8 > 64:
        return rows <= BLOCKS_ROWS
    if n8 % 16:
        return rows <= ODD_N_ROWS
    return not (n8 <= 16 and tiles >= TILES_TALL)


@functools.lru_cache(maxsize=None)
def narrow_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int, kp: int,
                option: Optional[tuple] = None) -> Optional[NarrowPlan]:
    """The narrow Hopper form's plan of one launch, or None where the form
    does not take the shape: a 3x3 pad 1 conv at stride 1 or a 1x1 pad 0
    conv at stride 1 or 2, over C % 16 == 0 channels, any N8 (a stride-2
    3x3's rows are no one stride in the band, which A's descriptor needs).
    N in one block of 16 or 32 columns, else blocks of 64; (MG, WM, WK) by
    _narrow_option's rule, or option where given (for A/B runs). K in
    chunks of the most channels (a multiple of 16 that divides C) whose ring
    of 3 stages fits SM90_SMEM beside the weight, in at most 8 chunks; else
    the most whose ring of 2 fits."""
    if ksize not in (1, 3) or KSIZES[ksize] != pad or stride not in (1, 2) or ksize == 3 and stride != 1:
        return None
    if c % 16 or n8 % N_MULT or n8 <= 0 or kp != _round_up(ksize * ksize * c, K_MULT):
        return None
    if option is None:
        option = _narrow_option(b, h, w, c, ksize, stride, pad, n8)
    chunks = [cc for cc in range(c, 0, -16) if c % cc == 0]
    for least, most_chunks in ((3, 8), (2, c // 16)):
        for cc in chunks:
            p = _narrow_layout(b, h, w, c, ksize, stride, pad, n8, cc, *option) if c // cc <= most_chunks else None
            if p is not None and p.n_stages >= least:
                return p
    return None


PLANE = FORM.format("sm90p")  # and of every launch of the plane form (csrc/qmatmul_sm90p.cu)
PLANE_CONSUMERS = 4  # its consumer warpgroups, each with its own stage and planes
# items of the most rows whose count reaches PLANE_ITEMS (two a CTA on an H100's
# 132 SMs), else of the fewest: where the plane form's item sizes were timed
# (PERF.md, K1's plane form) whole 16x16 images won at 2048, halves at 256
# (whole images there leave half the consumers idle), quarters at 8
PLANE_ITEMS = 264
# the 32x32 3x3s to 16 columns take the plane form where its items (4 an
# image) number this many (one a CTA): at batch 8 the narrow form won there,
# at 64 and up the plane form
PLANE_MIN_ITEMS = 132
_TABLE_BYTES = 1024 * 8  # csrc/act_codes.cuh TABLE_MAX entries of 8 bytes


class PlanePlan(NamedTuple):
    """One launch's plan in K1's plane form, in the order of
    csrc/qmatmul_sm90p.cu's Plan.

    A work item is TR output rows of an image (TY items an image, n_items
    in all; MG = TR * Wo / 64 m64 groups, 1, 2 or 4), its image rows
    brought as they lie into its consumer's stage (raw_bytes at most); the
    consumer warpgroup lays them out in its planes (plane_bytes): G groups
    of 16 channels, each NBX planes of BR rows by Wo pixels, 16 bytes a
    pixel (BOXB bytes): at stride 1 the planes of column offsets -1, 0, +1
    from row -1 (BR = TR + 2), at stride 2 one plane a tap sampled every
    other row and column (BR = TR). The weight's K runs in `steps` K steps
    (_plane_steps), KT = 32 * steps bytes a row, the whole (N8, KT)
    resident. The *_off fields place the shared-memory regions; smem: the
    bytes the launch asks for."""

    B: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    stride: int
    pad: int
    ksize: int
    N8: int
    Kp: int
    G: int
    NBX: int
    TR: int
    TY: int
    n_items: int
    BR: int
    BOXB: int
    steps: int
    KT: int
    MG: int
    raw_bytes: int
    plane_bytes: int
    w_off: int
    stage_off: int
    plane_off: int
    tab_off: int
    sb_off: int
    stab_off: int
    bar_off: int
    smem: int


def _plane_steps(g: int) -> list:
    """The plane form's K steps over g groups: _narrow_steps' order, each
    half (group, tau) with tau the tap in the order of its plane (plane_tap)."""
    return _narrow_steps(3, g)


def plane_tap(stride: int, tau: int) -> tuple:
    """(dy, dx) of the plane form's tap tau: dx-major at stride 1 (the
    three column-shifted planes in turn), row-major at stride 2 (a plane a
    tap)."""
    return (tau % 3, tau // 3) if stride == 1 else (tau // 3, tau % 3)


def plane_rows(ho: int, wo: int) -> list:
    """The output rows a plane-form item may take, most first: the whole
    image, a half, a quarter, those of 4, 2 or 1 m64 groups."""
    return [tr for tr in (ho, ho // 2, ho // 4) if tr >= 1 and ho % tr == 0 and tr * wo in (64, 128, 256)]


@functools.lru_cache(maxsize=None)
def plane_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int, kp: int,
               rows: Optional[int] = None) -> Optional[PlanePlan]:
    """The plane form's plan of one launch, or None where the form does not
    take the shape: a 3x3 pad 1 conv at stride 1 or 2 over 16 or 32
    channels (the kernel's K steps, 5 or 9, are constants) to N8 = 16 or 32
    columns, Wo a power of 2 from 8 to 128, whose four consumers' stages and
    planes fit beside the weight. Items of TR output rows: the most of
    plane_rows (at N8 = 16 those of 4 m64 groups only) whose items number
    PLANE_ITEMS or more, else the fewest; or `rows` where given (for A/B
    runs)."""
    if ksize != 3 or pad != 1 or stride not in (1, 2) or c not in (16, 32) or n8 not in (16, 32) or b < 1:
        return None
    if kp != _round_up(9 * c, K_MULT):
        return None
    ho, wo = conv_out_hw(h, w, 3, stride, 1)
    options = plane_rows(ho, wo) if wo in (8, 16, 32, 64, 128) else []
    if n8 == 16:  # the kernel is built for items of 4 m64 groups only there
        options = [tr for tr in options if tr * wo == 256]
    if rows is None and options:
        rows = next((tr for tr in options if b * (ho // tr) >= PLANE_ITEMS), options[-1])
    if rows not in options:
        return None
    g = c // 16
    nbx = 3 if stride == 1 else 9
    br = rows + 2 if stride == 1 else rows
    boxb = br * wo * 16
    steps = len(_plane_steps(g))
    kt = 32 * steps
    raw = _round_up(min(stride * (rows - 1) + 3, h) * w * c, 128)  # an item's image rows at most
    # the planes, and 16 bytes an odd group's last step may read; or the
    # outputs' staging, 4 warps' 16 rows in f32
    plane_bytes = _round_up(max(g * nbx * boxb + 16, 4 * 16 * n8 * 4), 128)
    stage_off = _round_up(n8 * kt, 128)
    plane_off = stage_off + PLANE_CONSUMERS * raw
    tab_off = plane_off + PLANE_CONSUMERS * plane_bytes
    sb_off = tab_off + _TABLE_BYTES
    stab_off = sb_off + 8 * n8
    bar_off = _round_up(stab_off + 8 * steps, 8)
    smem = bar_off + 8 * (2 * PLANE_CONSUMERS + 1)
    if smem > SM90_SMEM:
        return None
    return PlanePlan(b, h, w, c, ho, wo, stride, 1, 3, n8, kp, g, nbx, rows, ho // rows, b * (ho // rows), br, boxb,
                     steps, kt, rows * wo // 64, raw, plane_bytes, 0, stage_off, plane_off, tab_off, sb_off, stab_off,
                     bar_off, smem)


def plane_takes(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int) -> bool:
    """The planner's rule for the plane form, among the shapes plane_plan
    takes, where chip_smoke.py --k1-ab and --first-plane-ab timed it faster
    than the form the rule gave before (PERF.md, K1's plane form): the 3x3s
    to a 16x16 output and 32 columns (ResNet-20/56's block-3 stride-2 conv0
    from 32x32x16 and their 16x16 3x3s from 32 channels; mma.sync before),
    at every batch; the 32x32 3x3s to 16 columns at stride 1 (the narrow
    form's before: ResNet-20/56's stage-1 convs over 16 channels,
    DenseNet-40's first growth conv over 32) where their items (quarters of
    an image) number PLANE_MIN_ITEMS or more (at batch 8 the narrow form
    won or tied there, from 64 on the plane form)."""
    ho, wo = conv_out_hw(h, w, ksize, stride, pad)
    if ksize != 3 or pad != 1 or c not in (16, 32):
        return False
    if (ho, wo) == (16, 16):
        return n8 == 32
    return (ho, wo) == (32, 32) and stride == 1 and n8 == 16 and b * 4 >= PLANE_MIN_ITEMS


# id(wt), C, stride -> [a weak reference to wt, its re-packed copy]: an
# entry goes with its weight
_PLANE_WEIGHTS: dict = {}


@functools.lru_cache(maxsize=None)
def _plane_k_order(c: int, stride: int) -> np.ndarray:
    """The plane form's re-packed weight columns as indices into the packed
    (dy, dx, c) ones, -1 for a zero column: its K steps in turn
    (_plane_steps), each 16 bytes of a step the 16 channels of one group at
    one tap."""
    order = []
    for step in _plane_steps(c // 16):
        for half in step:
            if half is None:
                order.append(np.full(16, -1))
            else:
                q, tau = half
                dy, dx = plane_tap(stride, tau)
                order.append((3 * dy + dx) * c + 16 * q + np.arange(16))
    return np.concatenate(order)


def _plane_weight(wt: torch.Tensor, plan: PlanePlan) -> torch.Tensor:
    """wt (N8, Kp) re-packed for the plane form: its columns in
    _plane_k_order, each K step's two 16-byte halves laid out as wgmma's
    no-swizzle core matrices ([step][half][row][16 bytes], N8 * KT bytes),
    made once per weight tensor and kept while it lives."""
    key = (id(wt), plan.C, plan.stride)
    hit = _PLANE_WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        order = torch.from_numpy(_plane_k_order(plan.C, plan.stride)).to(wt.device)
        ext = torch.nn.functional.pad(wt, (0, 1))  # a zero column
        cols = ext.index_select(1, torch.where(order < 0, wt.shape[1], order))
        packed = cols.reshape(wt.shape[0], plan.steps, 2, 16).permute(1, 2, 0, 3).contiguous().reshape(-1)
        hit = [weakref.ref(wt, lambda _, k=key: _PLANE_WEIGHTS.pop(k, None)), packed]
        _PLANE_WEIGHTS[key] = hit
    return hit[1]


def _plane_lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul_sm90p")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k1_plane_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, p, p, p, i, i, p, f, f, i, i, p]
        lib.k1_plane_launch.restype = i
        lib.k1_plane_plan_ints.restype = i
        if lib.k1_plane_plan_ints() != len(PlanePlan._fields):
            raise RuntimeError("csrc/qmatmul_sm90p.cu's Plan does not match PlanePlan")
        lib._argtypes_set = True
    return lib


def table_args(act: Optional[ActMap], mode: str, device: torch.device) -> tuple:
    """The map's step table as the C entries of the table-mapping forms
    take it (entries, lo, hi, b_lo, n): act_table of an erf or poly map,
    relu'd where the map is; zeros in the other modes."""
    if mode not in ("poly", "erf"):
        return None, 0.0, 0.0, 0, 0
    t = act_table(act.impl, act.g, device, act.relu)
    return t.entries.data_ptr(), t.lo, t.hi, t.b_lo, t.entries.shape[0]


_MMA_ONLY = False  # set only by _mma_form
_PLANE_OFF = False  # set only by _old_form


@contextlib.contextmanager
def _mma_form():
    """Every launch planned inside takes the mma.sync form. For the A/B
    timing of the forms (chip_smoke.py --k1-ab); the main path never
    calls it."""
    global _MMA_ONLY
    saved, _MMA_ONLY = _MMA_ONLY, True
    try:
        yield
    finally:
        _MMA_ONLY = saved


@contextlib.contextmanager
def _old_form():
    """Every launch planned inside takes the form it took before the plane
    form: the shapes plane_takes gives the plane form go to the narrow form
    where narrow_takes gives them it, else to mma.sync. For the A/B timing
    of the plane form (chip_smoke.py --first-plane-ab, phase 10); the main
    path never calls it."""
    global _PLANE_OFF
    saved, _PLANE_OFF = _PLANE_OFF, True
    try:
        yield
    finally:
        _PLANE_OFF = saved


def k1_plan(b: int, h: int, w: int, c: int, ksize: int, stride: int, pad: int, n8: int,
            kp: int) -> Union[ConvPlan, Sm90Plan, PlanePlan, NarrowPlan]:
    """The plan of one K1 launch. The planner's rule: the Hopper form
    (sm90_plan) wherever it takes the shape, every 3x3 and 1x1 conv over
    C % 32 == 0 channels to N8 % 64 == 0 columns; else the plane form
    (plane_plan) where plane_takes gives it the shape (the 16x16 stage's
    stride-2 3x3 from 16 channels and 3x3s to 32 columns); else the narrow Hopper
    form (narrow_plan), the stride-1 3x3s and the 1x1s over C % 16 == 0
    channels, where narrow_takes gives it the shape (every one but those it
    measured slower: ResNet-20's stage-1 conv and block-3 skip, DenseNet-40's
    growth convs, the transitions and MobileNet-V2's narrow 1x1s at small
    batches); else the mma.sync form (conv_plan): the 7x7 stem, the 5x5
    VALID convs, the 4-channel first convs (where kernels/first_conv.py
    does not take them), the stride-2 3x3s plane_takes leaves, the 1x1s
    over 24 channels and the shapes narrow_takes leaves. chip_smoke.py
    --k1-ab timed the forms at every launch the Hopper forms take (PERF.md,
    K1's Hopper forms)."""
    if _MMA_ONLY:
        return conv_plan(b, h, w, c, ksize, stride, pad, n8, kp)
    plan = sm90_plan(b, h, w, c, ksize, stride, pad, n8, kp)
    if plan is None and not _PLANE_OFF and plane_takes(b, h, w, c, ksize, stride, pad, n8):
        plan = plane_plan(b, h, w, c, ksize, stride, pad, n8, kp)
    if plan is None and narrow_takes(b, h, w, c, ksize, stride, pad, n8):
        plan = narrow_plan(b, h, w, c, ksize, stride, pad, n8, kp)
    return conv_plan(b, h, w, c, ksize, stride, pad, n8, kp) if plan is None else plan


@functools.lru_cache(maxsize=None)
def _sm90_k_order(ksize: int, c: int, cc: int) -> np.ndarray:
    """The re-packed weight's columns as indices into the packed (dy, dx, c)
    ones: the chunks of cc channels in turn, each tap's channels of a chunk
    contiguous (tap-major, as the k-word table reads the band); then within
    each 32-byte K step, wgmma's position kappa takes k(kappa) = 8(kappa//4)
    + kappa%4 for kappa < 16 and 8((kappa-16)//4) + 4 + kappa%4 above, so
    that lane t's A registers a0 and a2 (positions 4t.. and 16+4t..) hold
    the 8 contiguous band bytes k = 8t..8t+7 of each row."""
    taps = ksize * ksize
    order = np.concatenate([
        (np.arange(taps)[:, None] * c + c0 + np.arange(min(cc, c - c0))[None, :]).reshape(-1)
        for c0 in range(0, c, cc)
    ])
    kappa = np.arange(32)
    k_of = np.where(kappa < 16, 8 * (kappa // 4) + kappa % 4, 8 * ((kappa - 16) // 4) + 4 + kappa % 4)
    return order.reshape(-1, 32)[:, k_of].reshape(-1)


# id(wt), ksize, C, CC -> [a weak reference to wt, its re-packed copy, the
# copy's tensor maps by (SWZ, NB)]: an entry goes with its weight
_SM90_WEIGHTS: dict = {}


def _sm90_entry(wt: torch.Tensor, plan: Sm90Plan) -> list:
    key = (id(wt), plan.ksize, plan.C, plan.CC)
    hit = _SM90_WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        order = torch.from_numpy(_sm90_k_order(plan.ksize, plan.C, plan.CC)).to(wt.device)
        hit = [weakref.ref(wt, lambda _, k=key: _SM90_WEIGHTS.pop(k, None)), wt.index_select(1, order).contiguous(), {}]
        _SM90_WEIGHTS[key] = hit
    return hit


def _sm90_weight(wt: torch.Tensor, plan: Sm90Plan) -> torch.Tensor:
    """wt (N8, Kp) re-packed in the Hopper form's K order (_sm90_k_order),
    made once per weight tensor and kept while it lives."""
    return _sm90_entry(wt, plan)[1]


def _sm90_map(wt: torch.Tensor, plan: Sm90Plan):
    """The bytes of the tensor map of _sm90_weight(wt, plan) in plan's
    boxes, encoded once and kept beside the re-packed copy."""
    _, packed, maps = _sm90_entry(wt, plan)
    wmap = maps.get((plan.SWZ, plan.NB))
    if wmap is None:
        lib = _sm90_lib()
        wmap = ctypes.create_string_buffer(lib.k1_sm90_map_bytes())
        with _build.on_device(wt.device):
            err = lib.k1_sm90_weight_map(packed.data_ptr(), plan.Kp, plan.N8, plan.SWZ, plan.NB, wmap)
        _build.check(err, "qmatmul_sm90.cu k1_sm90_weight_map")
        maps[plan.SWZ, plan.NB] = wmap
    return wmap


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_sm90_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, p, p, p, i, i, p]
        lib.k1_sm90_launch.restype = i
        lib.k1_sm90_weight_map.argtypes = [p, i, i, i, i, p]
        lib.k1_sm90_weight_map.restype = i
        lib.k1_sm90_map_bytes.restype = i
        lib.k1_sm90_plan_ints.restype = i
        if lib.k1_sm90_plan_ints() != len(Sm90Plan._fields):
            raise RuntimeError("csrc/qmatmul_sm90.cu's Plan does not match Sm90Plan")
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _narrow_k_order(ksize: int, c: int, cc: int) -> np.ndarray:
    """The narrow form's re-packed weight columns as indices into the packed
    (dy, dx, c) ones, -1 for a zero column: the chunks of cc channels in
    turn, each's K steps in _narrow_steps' order, each 16 bytes of a step
    the 16 channels of one group at one tap (A's first and second core
    matrices)."""
    order = []
    for c0 in range(0, c, cc):
        for step in _narrow_steps(ksize, cc // 16):
            for half in step:
                if half is None:
                    order.append(np.full(16, -1))
                else:
                    q, t = half
                    order.append(t * c + c0 + 16 * q + np.arange(16))
    return np.concatenate(order)


# id(wt), ksize, C, CC, rows -> [a weak reference to wt, its re-packed
# copy, the copy's tensor maps by (SWZ, NB)]: an entry goes with its weight
_NARROW_WEIGHTS: dict = {}


def _narrow_entry(wt: torch.Tensor, plan: NarrowPlan) -> list:
    rows = plan.NB * plan.n_blocks
    key = (id(wt), plan.ksize, plan.C, plan.CC, rows)
    hit = _NARROW_WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        order = torch.from_numpy(_narrow_k_order(plan.ksize, plan.C, plan.CC)).to(wt.device)
        ext = torch.nn.functional.pad(wt, (0, 1, 0, rows - wt.shape[0]))  # a zero column, the padded rows
        packed = ext.index_select(1, torch.where(order < 0, wt.shape[1], order)).contiguous()
        hit = [weakref.ref(wt, lambda _, k=key: _NARROW_WEIGHTS.pop(k, None)), packed, {}]
        _NARROW_WEIGHTS[key] = hit
    return hit


def _narrow_weight(wt: torch.Tensor, plan: NarrowPlan) -> torch.Tensor:
    """wt (N8, Kp) re-packed in the narrow form's K order (_narrow_k_order),
    (n_blocks * NB, KT) with zero rows past N8, made once per weight tensor
    and kept while it lives."""
    return _narrow_entry(wt, plan)[1]


def _narrow_map(wt: torch.Tensor, plan: NarrowPlan):
    """The bytes of the tensor map of _narrow_weight(wt, plan) in plan's
    boxes, encoded once and kept beside the re-packed copy."""
    _, packed, maps = _narrow_entry(wt, plan)
    wmap = maps.get((plan.SWZ, plan.NB))
    if wmap is None:
        lib = _narrow_lib()
        wmap = ctypes.create_string_buffer(lib.k1_narrow_map_bytes())
        with _build.on_device(wt.device):
            err = lib.k1_narrow_weight_map(packed.data_ptr(), plan.KT, packed.shape[0], plan.SWZ, plan.NB, wmap)
        _build.check(err, "qmatmul_sm90n.cu k1_narrow_weight_map")
        maps[plan.SWZ, plan.NB] = wmap
    return wmap


def _narrow_lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul_sm90n")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_narrow_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, p, p, p, p, i, i, p]
        lib.k1_narrow_launch.restype = i
        lib.k1_narrow_weight_map.argtypes = [p, i, i, i, i, p]
        lib.k1_narrow_weight_map.restype = i
        lib.k1_narrow_map_bytes.restype = i
        lib.k1_narrow_plan_ints.restype = i
        if lib.k1_narrow_plan_ints() != len(NarrowPlan._fields):
            raise RuntimeError("csrc/qmatmul_sm90n.cu's Plan does not match NarrowPlan")
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _plan_ints(plan):
    return (ctypes.c_int * len(plan))(*plan)


def _check_operands(x: torch.Tensor, op: K1Weights) -> None:
    if x.dtype != torch.int8 or op.wt.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {op.wt.dtype}")


def _chain(x: torch.Tensor, op: K1Weights) -> torch.Tensor:
    """x (M, K) int8 checked against a packed weight, K zero-padded to its depth."""
    _check_operands(x, op)
    kp = op.wt.shape[1]
    if x.ndim != 2 or x.shape[1] > kp:
        raise ValueError(f"x {tuple(x.shape)} does not chain with a packed weight of depth {kp}")
    if x.shape[1] != kp:
        x = torch.nn.functional.pad(x, (0, kp - x.shape[1]))
    return x


def _conv_input(x: torch.Tensor, op: K1Weights) -> torch.Tensor:
    """NHWC int8 x checked against a packed conv weight, its channels
    zero-padded to the weight's (the stem's 3 -> 4)."""
    _check_operands(x, op)
    if x.ndim != 4 or x.shape[-1] > op.cin:
        raise ValueError(f"x {tuple(x.shape)} does not fit a packed conv weight of {op.cin} input channels")
    if x.shape[-1] != op.cin:
        x = torch.nn.functional.pad(x, (0, op.cin - x.shape[-1]))
    return x


def _run_k1(x, op: K1Weights, ksize, stride, padding, mode: str, act: Optional[ActMap] = None) -> torch.Tensor:
    """K1 on CUDA NHWC x (B, H, W, C) int8, into a new (B*Ho*Wo, N) out:
    operands checked, the plan chosen, the launch counted."""
    tensors = [x, *op[:3]] + ([t for t in act[2:6] if t is not None] if act is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, the packed weight and the act map must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16 or op.wt.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned operands")
    n8, kp = op.wt.shape
    plan = k1_plan(*x.shape, ksize, stride, padding, n8, kp)
    dtype = {"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8)
    out = torch.empty((plan.B * plan.Ho * plan.Wo, n8), device=x.device, dtype=dtype)
    if out.shape[0]:
        _k1_launch(x, op, plan, out, mode, act)
        _build.launches[KERNEL] += 1
        _build.launches[f"{KERNEL}:{_FAMILY.get(mode, 'codes')}"] += 1
        _build.launches[MODE.format(mode)] += 1
        _build.launches[FORM.format(ksize)] += 1
        if isinstance(plan, Sm90Plan):
            _build.launches[SM90] += 1
        elif isinstance(plan, NarrowPlan):
            _build.launches[NARROW] += 1
        elif isinstance(plan, PlanePlan):
            _build.launches[PLANE] += 1
    return out if n8 == op.n else out[:, : op.n]


def _k1_launch(x, op: K1Weights, plan, out, mode: str, act: Optional[ActMap] = None) -> None:
    """One launch of K1 on checked operands, in the form of its plan
    (ConvPlan: csrc/qmatmul.cu; Sm90Plan: csrc/qmatmul_sm90.cu, NarrowPlan:
    csrc/qmatmul_sm90n.cu, each on the tensor map of the weight re-packed
    for it): x NHWC int8, op's wt (N8, Kp) int8 and
    scale/bias (N8,) f32 (unread in modes 'int32' and 'bins_int'; in
    'requant' the bias holds the reciprocal of the output's scale), out
    (B*Ho*Wo, N8) of the mode's type; act, the map of a codes mode (PlanePlan:
    csrc/qmatmul_sm90p.cu on the weight re-packed for it, the erf and poly
    maps through their step tables). Counts nothing (the wrapper does). A
    launch that fails raises."""
    bnd, sgn, t1, t2 = (None,) * 4 if act is None else act[2:6]

    def ptr(t):
        return None if t is None else t.data_ptr()

    if isinstance(plan, PlanePlan):
        with _build.on_device(x.device):
            err = _plane_lib().k1_plane_launch(
                x.data_ptr(), _plane_weight(op.wt, plan).data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
                out.data_ptr(), _plan_ints(plan), _MODE[mode], ptr(bnd), ptr(sgn), ptr(t1), ptr(t2),
                0 if act is None else act.g, int(act is not None and act.relu), *table_args(act, mode, x.device),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        _build.check(err, "qmatmul_sm90p.cu k1_plane_kernel")
        return
    if isinstance(plan, Sm90Plan):
        what, launch, wt = "qmatmul_sm90.cu k1_sm90_kernel", _sm90_lib().k1_sm90_launch, _sm90_map(op.wt, plan)
    elif isinstance(plan, NarrowPlan):
        what, launch, wt = "qmatmul_sm90n.cu k1_narrow_kernel", _narrow_lib().k1_narrow_launch, _narrow_map(op.wt, plan)
    else:
        what, launch, wt = "qmatmul.cu k1_conv_kernel", _lib().k1_conv_launch, op.wt.data_ptr()
    with _build.on_device(x.device):
        err = launch(
            x.data_ptr(), wt, op.scale.data_ptr(), op.bias.data_ptr(), out.data_ptr(),
            _plan_ints(plan), _MODE[mode], ptr(bnd), ptr(sgn), ptr(t1), ptr(t2),
            0 if act is None else act.g, int(act is not None and act.relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, what)


def requant_int8(value: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(value * inv), +-127) int8: a stage buffer's requant, inv
    the f32 reciprocal of the buffer slice's scale (one f32 rounding)."""
    return torch.clamp(torch.round(value * inv), -127.0, 127.0).to(torch.int8)


def _packed_reference(x: torch.Tensor, op: K1Weights, mode: str, act: Optional[ActMap] = None) -> torch.Tensor:
    """Plain x (M, Kp) @ a packed weight: the act codes where act is given
    (act_codes of the f32 epilogue, or int_bin_codes of the int32
    accumulator for bins_int; relu'd where act.relu), else the epilogue
    `mode` ('requant': requant_int8 of acc * scale, inv in the bias)."""
    n = op.n
    w = op.wt[:n].t()
    if act is not None:
        if act.impl == "bins_int":
            codes = int_bin_codes(int8_matmul_int32_reference(x, w), act.sgn[:n], act.t1[:, :n], act.t2[:, :n])
        else:
            codes = act_codes(int8_matmul_dequant_reference(x, w, op.scale[:n], op.bias[:n]), act.g, act.impl)
        return torch.clamp_min(codes, 0) if act.relu else codes
    if mode == "int32":
        return int8_matmul_int32_reference(x, w)
    if mode == "requant":
        return requant_int8(int8_matmul_int32_reference(x, w).float() * op.scale[:n], op.bias[:n])
    return int8_matmul_dequant_reference(x, w, op.scale[:n], op.bias[:n], relu=mode == "relu")


def _check_act(op: K1Weights, act: ActMap) -> None:
    if act.impl == "bins_int" and act.sgn.shape[0] != op.wt.shape[0]:
        raise ValueError("the cutpoints are not padded to the packed weight's width")


def _gemm(x: torch.Tensor, op: K1Weights, mode: str, act: Optional[ActMap] = None) -> torch.Tensor:
    """x (M, K) @ a packed weight: the plain version on a CPU tensor, else
    K1 as a 1x1 stride-1 conv over the (1, 1, M, Kp) view."""
    x = _chain(x, op)
    if x.device.type == "cpu":
        return _gather_n(_packed_reference(x, op, mode, act), op)
    m, kp = x.shape
    return _gather_n(_run_k1(x.reshape(1, 1, m, kp), op, 1, 1, 0, mode, act), op)


def int8_matmul_packed(x: torch.Tensor, op: K1Weights, mode: str = "f32") -> torch.Tensor:
    """x (M, K) int8 @ a packed weight: the raw int32 accumulator
    (mode 'int32') or the f32 epilogue (mode 'f32', or 'relu' with relu).
    K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if mode not in _FAMILY:
        raise ValueError(f"unknown mode {mode!r}")
    return _gemm(x, op, mode)


def int8_matmul_codes_reference(x: torch.Tensor, op: K1Weights, act: ActMap) -> torch.Tensor:
    """Plain codes: act_codes of the f32 epilogue, or int_bin_codes of the
    int32 accumulator for bins_int."""
    return _packed_reference(_chain(x, op), op, act.impl, act)


def int8_matmul_codes(x: torch.Tensor, op: K1Weights, act: ActMap) -> torch.Tensor:
    """The act codes (M, N) int8 of x (M, K) int8 @ a packed weight: K1's
    codes epilogue on a CUDA tensor, int8_matmul_codes_reference on a CPU
    tensor."""
    _check_act(op, act)
    return _gemm(x, op, act.impl, act)


def int8_conv_reference(x: torch.Tensor, op: K1Weights, stride: int, padding: int, mode: str = "f32",
                        act: Optional[ActMap] = None) -> torch.Tensor:
    """Plain conv: gather_taps, then the plain GEMM of its epilogue (mode,
    or the act codes where act is given). (B, Ho, Wo, N)."""
    x = _conv_input(x, op)
    b, h, w, _ = x.shape
    ho, wo = conv_out_hw(h, w, op.ksize, stride, padding)
    cols = gather_taps(x, op.ksize, stride, padding, K_MULT)
    return _packed_reference(cols, op, mode, act).reshape(b, ho, wo, -1)


def _conv(x, op: K1Weights, stride, padding, mode, act=None) -> torch.Tensor:
    """The conv entry points' one site: K1 (or its plain version on a CPU
    tensor) on this rank's weight, then, for a column-parallel weight, its
    output's channels gathered over the model axis in rank order."""
    x = _conv_input(x, op)
    if x.device.type == "cpu":
        return _gather_n(int8_conv_reference(x, op, stride, padding, mode, act), op)
    b, h, w, _ = x.shape
    ho, wo = conv_out_hw(h, w, op.ksize, stride, padding)
    return _gather_n(_run_k1(x, op, op.ksize, stride, padding, mode, act).reshape(b, ho, wo, -1), op)


def int8_conv_packed(x: torch.Tensor, op: K1Weights, stride: int = 1, padding: int = 1,
                     mode: str = "f32") -> torch.Tensor:
    """A conv of NHWC int8 codes x (B, H, W, Cin) with a packed conv weight
    (pack_conv_weights): the raw int32 accumulator (mode 'int32'), the f32
    epilogue ('f32', or 'relu'), or a stage buffer's int8 requant of it
    ('requant': clip(rint((acc * scale) * inv), +-127), inv packed as the
    bias), (B, Ho, Wo, N). K1 reading x in place on a CUDA tensor (3x3 pad
    1, 1x1 pad 0, 7x7 pad 3 or 5x5 pad 0, stride 1 or 2); on a CPU tensor its plain
    version, int8_conv_reference."""
    if mode not in _FAMILY:
        raise ValueError(f"unknown mode {mode!r}")
    return _conv(x, op, stride, padding, mode)


def int8_conv_codes(x: torch.Tensor, op: K1Weights, stride: int, padding: int, act: ActMap) -> torch.Tensor:
    """The act codes (B, Ho, Wo, N) int8 of a conv of NHWC int8 codes x
    with a packed conv weight: K1's codes epilogue on a CUDA tensor,
    int8_conv_reference on a CPU tensor."""
    _check_act(op, act)
    return _conv(x, op, stride, padding, act.impl, act)


def int8_matmul_dequant(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (N,) f32 combined act*weight dequant scale
    bias: torch.Tensor | None = None,  # (N,) f32 fused bias / BN shift
    relu: bool = False,
) -> torch.Tensor:
    """y[M, N] = relu?((x @ w) * scale + bias) in f32."""
    if x.device.type == "cpu":
        return int8_matmul_dequant_reference(x, w, scale, bias, relu)
    return int8_matmul_packed(x, pack_k1_weights(w, scale, bias), "relu" if relu else "f32")


def int8_matmul_int32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Raw int32 accumulator (M, N) of x @ w: K1 with no epilogue (the
    bins_int act sites compare it against integer cutpoints)."""
    if x.device.type == "cpu":
        return int8_matmul_int32_reference(x, w)
    return int8_matmul_packed(x, pack_k1_weights(w), "int32")
