"""The ImageNet trunks' stem as one Hopper kernel: the f32 image to the
pooled codes (csrc/stem_sm90.cu).

The JAX serving graph's stem (alignq_tpu/kernels/infer_resnet_imagenet.py
resnet_imagenet_int8_forward) is `_linear_q` of the image, the 7x7 stride-2
conv1 (pad 3) with its BN folded, the act codes relu'd, and the 3x3
stride-2 max pool (pad 1) of the codes. `stem_pool_codes` returns that
pooled stream, int16 (B, Ho/2, Wo/2, 64):

- on a CUDA tensor whose shape the form takes (`stem_takes`: conv1 to 64
  channels over the 3-channel image, W % 4 == 0, an even conv output, the
  erf, poly or bins map relu'd), two launches: `stem_prep_kernel`
  quantizes the image and pads its channels to 4, then `stem_kernel`
  computes conv, codes and pool in one pass (wgmma, the band by TMA, the
  erf and poly maps through their step tables, kernels/quantize.py
  act_table);
- on any other CUDA input, the chain it replaced (`stem_chain`): K1's 7x7
  form (kernels/qmatmul.py), then the max pool on an exact f16 copy;
- on a CPU tensor, `stem_chain` too, K1 then being its plain version.

The form agrees with the chain bit for bit (chip_smoke.py holds it so on
every launch of the trunks' forwards). Launches count under STEM (and
under K1's KERNEL, CODES and MODE keys, as the conv they replace did), the
prep pass under PREP; `_old_form()` gives every stem the chain, for A/B
runs only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels.infer import S_IMG, _linear_q
from alignq_tpu_torch.kernels.quantize import ActTable, act_table, k2_table

STEM = K1.KERNEL + ":stem_sm90"  # launch-counter key of the stem kernel
PREP = STEM + ":prep"  # ... of the pass before it
N_OUT = 64  # the stem's output channels: the ResNets' conv1
STEM_R = 2  # pooled rows a tile
STEM_WG = 4  # warpgroups a CTA
SMEM_MAX = 227 * 1024  # shared memory a CTA may take on an H100
# csrc/stem_sm90.cu's SLAB, AP (in bytes), W_BYTES and TABLE_ROOM (entries of 8 bytes)
_SLAB, _AP, _W_BYTES, _TABLE_BYTES = 256, 4 * (64 + 8), 7 * 2048, 512 * 8
_MODE = {"poly": 3, "erf": 4, "bins": 5}  # csrc/k1_epilogue.cuh's mode codes


class StemPlan(NamedTuple):
    """One stem launch's tiling, in the order of csrc/stem_sm90.cu's Plan."""

    B: int
    H: int
    W: int
    Ho: int
    Wo: int
    Hp: int
    Wp: int
    R: int  # pooled rows a tile
    CR: int  # conv rows a tile, 2R + 1
    BR: int  # image rows of its band, 4R + 7
    NS: int  # slabs of 256 bytes a band row
    TY: int  # tiles an image
    n_tiles: int
    MT: int  # conv outputs a tile, CR * Wo
    n_groups: int  # its m64 groups
    n_wg: int  # warpgroups a CTA
    band_bytes: int
    w_off: int
    acc_off: int
    tab_off: int
    sb_off: int
    bar_off: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stem_plan(b: int, h: int, w: int, c: int, n: int, r: int = STEM_R, n_wg: int = STEM_WG) -> StemPlan:
    """The plan of the stem kernel over images (b, h, w, c) to n channels:
    tiles of r pooled rows (the last one ragged), n_wg warpgroups a CTA.
    Raises ValueError, naming the shape, for one the kernel does not take:
    c != 3 or 4, n != 64, w % 4, an odd conv output, an empty batch, or
    tiles that do not fit a CTA's shared memory."""
    ho, wo = K1.conv_out_hw(h, w, 7, 2, 3)
    shape = f"images ({b}, {h}, {w}, {c}) to {n} channels, tiles of {r} pooled rows"
    if c not in (3, 4) or n != N_OUT or w % 4 or ho % 2 or wo % 2 or b < 1 or h < 1 or r < 1 or n_wg not in (1, 2, 4):
        raise ValueError(f"the stem kernel does not take {shape}: it takes 3 (or 4) channels to 64, W % 4 == 0 and "
                         f"an even conv output")
    cr, br = 2 * r + 1, 4 * r + 7
    ns = -(-(8 * wo + 24) // _SLAB)
    hp, wp = ho // 2, wo // 2
    ty = -(-hp // r)
    mt = cr * wo
    band = ns * br * _SLAB
    w_off = 2 * band
    acc_off = w_off + _W_BYTES
    tab_off = _round_up(acc_off + mt * _AP, 16)
    sb_off = tab_off + _TABLE_BYTES
    bar_off = sb_off + 2 * N_OUT * 4
    smem = bar_off + 3 * 8 + 1024  # and the base's alignment to 1024 bytes
    if br > 256 or smem > SMEM_MAX:
        raise ValueError(f"the stem kernel does not take {shape}: {smem} bytes of shared memory a CTA")
    return StemPlan(b, h, w, ho, wo, hp, wp, r, cr, br, ns, ty, b * ty, mt, -(-mt // 64), n_wg, band, w_off,
                    acc_off, tab_off, sb_off, bar_off, smem)


_OLD_FORM = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every stem inside takes the chain the kernel replaced (stem_chain).
    For the A/B timing of the two (chip_smoke.py --stem-dw-ab); the main
    path never calls it."""
    global _OLD_FORM
    saved, _OLD_FORM = _OLD_FORM, True
    try:
        yield
    finally:
        _OLD_FORM = saved


def stem_takes(x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> bool:
    """The rule: the kernel takes a stem over f32 NHWC images of 3
    channels, W % 4 == 0 and an even conv output, a whole (unsharded) 7x7
    weight to 64 channels, and the erf, poly or bins map relu'd."""
    if _OLD_FORM or x.ndim != 4 or x.dtype != torch.float32 or x.shape[-1] != 3:
        return False
    if op.ksize != 7 or op.cin != 4 or op.n != N_OUT or op.shard is not None or tuple(op.wt.shape) != (N_OUT, 224):
        return False
    if act.impl not in _MODE or not act.relu:
        return False
    b, h, w, _ = x.shape
    ho, wo = K1.conv_out_hw(h, w, 7, 2, 3)
    return b > 0 and w % 4 == 0 and ho % 2 == 0 and wo % 2 == 0


def _pool(c: torch.Tensor) -> torch.Tensor:
    """The 3x3 stride-2 max pool (pad 1) of NHWC codes on an exact f16 copy
    (0..127 after the relu; the -inf pad never wins), as int16."""
    pooled = F.max_pool2d(c.to(torch.float16).permute(0, 3, 1, 2), 3, 2, 1)
    return pooled.permute(0, 2, 3, 1).to(torch.int16)


def stem_chain(x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The stem as separate passes: _linear_q, K1's 7x7 form (its plain
    version on a CPU tensor), the pool. int16 (B, Ho/2, Wo/2, N). On a CPU
    tensor the plain version of the stem kernel."""
    return _pool(K1.int8_conv_codes(_linear_q(x, S_IMG), op, 2, 3, act))


def stem_reference(x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The plain version of the stem kernel on any device: _linear_q, K1's
    plain conv (int8_conv_reference), the pool; stem_chain on a CPU
    tensor."""
    return _pool(K1.int8_conv_reference(_linear_q(x, S_IMG), op, 2, 3, act.impl, act))


@functools.lru_cache(maxsize=None)
def stem_k_order() -> np.ndarray:
    """The re-packed weight's bytes as indices into the packed (dy, dx, c)
    columns (7 x 7 x 4 = 196 of them), -1 for a zero byte: K step dy (2048
    bytes) in wgmma's no-swizzle core-matrix order, [half h][column group
    q][column i][byte j] for column 8q + i and K position 16h + j; position
    4p + c holds tap dx = 2p (p < 4) or 2(p - 4) + 1 (p >= 4), channel c,
    since lane t's 8 band bytes (pixels 2t, 2t + 1) fill its positions 4t..
    and 16 + 4t.. (dx = 7 is zero)."""
    dy, h, q, i, j = np.meshgrid(np.arange(7), np.arange(2), np.arange(8), np.arange(8), np.arange(16), indexing="ij")
    pos = 16 * h + j
    p, c = pos // 4, pos % 4
    dx = np.where(p < 4, 2 * p, 2 * (p - 4) + 1)
    col = (dy * 7 + dx) * 4 + c
    n = 8 * q + i
    return np.where(dx < 7, n * 224 + col, -1).reshape(-1)


# id(wt) -> [a weak reference to wt, its re-packed copy]: an entry goes with its weight
_WEIGHTS: dict = {}


def stem_weight(wt: torch.Tensor) -> torch.Tensor:
    """wt (64, 224) re-packed for the kernel (stem_k_order), 14,336 bytes,
    made once per weight tensor and kept while it lives."""
    key = id(wt)
    hit = _WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        order = torch.from_numpy(stem_k_order()).to(wt.device)
        flat = torch.cat([wt.reshape(-1), wt.new_zeros(1)])
        packed = flat[torch.where(order < 0, wt.numel(), order)].contiguous()
        hit = [weakref.ref(wt, lambda _, k=key: _WEIGHTS.pop(k, None)), packed]
        _WEIGHTS[key] = hit
    return hit[1]


def _lib() -> ctypes.CDLL:
    lib = _build.load("stem_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        lib.stem_launch.argtypes = [p, p, p, p, p, f, f, i, i, p, i, i, p, ctypes.POINTER(i), p]
        lib.stem_launch.restype = i
        lib.stem_prep_launch.argtypes = [p, p, ctypes.c_longlong, i, ctypes.c_float, p]
        lib.stem_prep_launch.restype = i
        lib.act_table_check.argtypes = [p, f, f, i, i, i, i, i, p, p]
        lib.act_table_check.restype = i
        lib.stem_plan_ints.restype = i
        if lib.stem_plan_ints() != len(StemPlan._fields):
            raise RuntimeError("csrc/stem_sm90.cu's Plan does not match StemPlan")
        lib._argtypes_set = True
    return lib


_INV_S_IMG = float(np.float32(1.0 / S_IMG))  # _linear_q's multiplier, as the f32 the multiply takes


def _prep_launch(x: torch.Tensor, q: torch.Tensor, inv: float = _INV_S_IMG) -> None:
    """One launch of stem_prep_kernel: x (B, H, W, 3) f32 contiguous into q
    (B, H, W + 4, 4) int8, quantized by the multiplier inv (the stem's
    1 / S_IMG; kernels/digit.py passes the digit net's). Counts nothing
    (the wrapper does)."""
    b, h, w, _ = x.shape
    with _build.on_device(x.device):
        err = _lib().stem_prep_launch(x.data_ptr(), q.data_ptr(), b * h, w, inv,
                                      torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stem_sm90.cu stem_prep_kernel")


def _stem_launch(xq: torch.Tensor, op: K1.K1Weights, act: K1.ActMap, plan: StemPlan, out: torch.Tensor) -> None:
    """One launch of stem_kernel on checked operands: xq (B, H, W + 4, 4) int8,
    op's weight re-packed (stem_weight), out (B, Hp, Wp, 64) int16. Counts
    nothing (the wrapper does)."""
    t = act_table(act.impl, act.g, xq.device) if act.impl != "bins" else None
    with _build.on_device(xq.device):
        err = _lib().stem_launch(
            xq.data_ptr(), stem_weight(op.wt).data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
            *((None, 0.0, 0.0, 0, 0) if t is None else _table_args(t)),
            None if act.bnd is None else act.bnd.data_ptr(), act.g, _MODE[act.impl], out.data_ptr(),
            K1._plan_ints(plan), torch.cuda.current_stream(xq.device).cuda_stream,
        )
    _build.check(err, "stem_sm90.cu stem_kernel")


def stem_prep(x: torch.Tensor) -> torch.Tensor:
    """_linear_q of the f32 image (B, H, W, 3) in the layout the stem
    kernel reads: its channels zero-padded to 4, 3 zero columns on the left
    (the conv's pad: a TMA box starts 16-byte aligned) and 1 on the right
    (a row of 16-byte multiples), int8 (B, H, W + 4, 4). The prep kernel on
    a CUDA tensor (W % 4 == 0), the plain passes on a CPU tensor."""
    if x.device.type == "cpu":
        return F.pad(_linear_q(x, S_IMG), (0, 1, 3, 1))
    x = x.contiguous()
    if x.dtype != torch.float32 or x.ndim != 4 or x.shape[-1] != 3 or x.shape[2] % 4 or x.shape[2] < 4:
        raise ValueError(f"the stem's prep pass takes f32 images (B, H, W % 4 == 0, 3), got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, _ = x.shape
    q = torch.empty((b, h, w + 4, 4), dtype=torch.int8, device=x.device)
    if q.numel():
        _prep_launch(x, q)
        _build.launches[PREP] += 1
    return q


def stem_pool_codes(x: torch.Tensor, op: K1.K1Weights, act: K1.ActMap) -> torch.Tensor:
    """The trunk's stem: f32 NHWC images (B, H, W, 3), conv1's packed
    weight and its act map (relu'd) -> the pooled codes int16
    (B, Ho/2, Wo/2, N). The stem kernel (after its prep pass) where
    stem_takes gives it the shape, else stem_chain (always on a CPU
    tensor)."""
    if x.device.type == "cpu" or not stem_takes(x, op, act):
        return stem_chain(x, op, act)
    if len({t.device for t in (x, *op[:3])}) != 1:
        raise ValueError("the images and the packed weight must lie on one device")
    b, h, w, _ = x.shape
    plan = stem_plan(b, h, w, 3, op.n)
    xq = stem_prep(x)
    out = torch.empty((b, plan.Hp, plan.Wp, N_OUT), dtype=torch.int16, device=x.device)
    _stem_launch(xq, op, act, plan, out)
    _build.launches[STEM] += 1
    _build.launches[K1.KERNEL] += 1
    _build.launches[K1.CODES] += 1
    _build.launches[K1.MODE.format(act.impl)] += 1
    return out


def _table_args(t: ActTable) -> tuple:
    """An ActTable as the C entries take it: entries, lo, hi, b_lo, n."""
    return t.entries.data_ptr(), t.lo, t.hi, t.b_lo, t.entries.shape[0]


_CHECK_MODE = {"poly": 3, "erf": 4, "as": 8}  # act_table_check's maps: _MODE's, and act_codes.cuh's AS


def act_table_differences(impl: str, g: int, relu: bool, device: torch.device):
    """(differing patterns, the least one or None): the table form of the
    erf or poly map of grid g, relu'd or not, or of K2's map ('as', g 127,
    not relu'd: k2_table, built from the card's own map) (act_codes.cuh
    table_code on the table's arrays), against the direct map, on the
    card, over all 2^32 f32 bit patterns."""
    t = k2_table(device) if impl == "as" else act_table(impl, g, device, relu)
    diffs = torch.tensor([0, -1], dtype=torch.int64, device=device)
    with _build.on_device(device):
        err = _lib().act_table_check(*_table_args(t), _CHECK_MODE[impl], g, int(relu), diffs.data_ptr(),
                                     torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "stem_sm90.cu table_check_kernel")
    n, first = (int(v) for v in diffs.cpu())
    return n, (None if n == 0 else first & 0xFFFFFFFF)
