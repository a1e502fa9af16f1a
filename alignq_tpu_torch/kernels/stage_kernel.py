"""Stage-interior megakernel for the INT8 PreAct ResNet graph (kernel K3).

Port of alignq_tpu/kernels/stage_kernel.py. `stage_identity_blocks_nhwc`
runs n consecutive stride-1 identity blocks on the int16 residual code
stream in the forward's own layout, (B, H, W, C). On a CUDA tensor it
launches K3 in one of two forms that the planner (`k3_plan`) chooses by
the shape: csrc/stage_kernel_sm90.cu (wgmma, weights and planes by TMA,
the block-edge requant in the residual epilogue, several images a CTA
where planes are small) wherever it takes the shape, every C in (16, 32,
64) with H*W % 64 == 0 (ResNet-20's and ResNet-56's stages); else
csrc/stage_kernel.cu (mma.sync, one image a CTA). Both keep each image's
stream plane in shared memory through all n blocks and give the same
stream bit for bit. On a CPU tensor it runs the plain version,
`stage_identity_blocks_nhwc_reference`, whose convs accumulate in float64
(exact: every partial sum is an integer below 2^53).
`stage_identity_blocks` keeps the JAX signature, (C, B*H*W), around it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.qmatmul import gather_taps, int8_matmul_int32_reference
from alignq_tpu_torch.quant.cdf import erf_sqrt2, fma_f32

KERNEL = "stage_identity_blocks"  # launch-counter key of every K3 launch
SM90 = KERNEL + ":sm90"  # and of every launch of the Hopper form (csrc/stage_kernel_sm90.cu)
CHANNELS = (16, 32, 64)  # the widths both CUDA forms are instantiated for
MAX_BLOCKS = 32
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _poly_codes(h: torch.Tensor, g: float) -> torch.Tensor:
    """round(poly_cdf(h) * g) codes as int32, kernels/infer.py's
    _erfq_codes(impl='poly') before its int8 cast."""
    c = erf_sqrt2(h, "poly")
    return torch.clamp(torch.round(c * g), -g, g).to(torch.int32)


def requant_magic(m: int) -> int:
    """ceil(2^32 / (2m)): the Hopper form's constant for block multiplier
    m, computed on the host. For 0 <= n < 2^17, n // (2m) = (n * magic) >>
    32 exactly: magic = (2^32 + e) / (2m) with 0 <= e < 2m <= 66, so the
    product overshoots n / (2m) by n e / (2m 2^32) < 1 / (2m)."""
    if not 1 <= m <= MAX_BLOCKS + 1:
        raise ValueError(f"block multiplier {m} out of 1..{MAX_BLOCKS + 1}")
    return -(-(1 << 32) // (2 * m))


def requant_mulshift(k, m: int, g: int):
    """The Hopper form's requant of int codes k (numpy), as its epilogue
    computes it: min(umulhi(max(2k + m, 0), requant_magic(m)), g)."""
    n = np.maximum(2 * np.asarray(k, dtype=np.int64) + m, 0).astype(np.uint64)
    return np.minimum((n * np.uint64(requant_magic(m))) >> np.uint64(32), np.uint64(g)).astype(np.int64)


def _requant(k32: torch.Tensor, m: int, g: int) -> torch.Tensor:
    """kernels/infer.py _requant_codes on int32 codes K >= 0 (int32 out)."""
    if m == 1:
        return torch.clamp(k32, 0, g)
    return torch.clamp(torch.div(2 * k32 + m, 2 * m, rounding_mode="floor"), 0, g)


def stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, g):
    """Plain version on the NHWC stream x (B, H, W, C) int16: the same
    blocks as convs over gathered taps. scale/bias: (n_blocks, 2, C),
    broadcast over the channel axis."""
    batch, h_img, w_img, c = x.shape
    out_c = x.to(torch.int32)
    for b in range(wt.shape[0]):
        x8 = _requant(out_c, ms[b], g)
        for j in range(2):
            inp = x8 if j == 0 else r
            # W^T (C_out, 9 C_in), taps row-major: its transpose is the
            # (9 C_in, C_out) matrix gather_taps' columns meet
            acc = int8_matmul_int32_reference(gather_taps(inp, 3, 1, 1), wt[b, j].t())
            hj = fma_f32(acc.float(), scale[b, j], bias[b, j])
            codes = _poly_codes(hj, float(g)).reshape(batch, h_img, w_img, c)
            if j == 0:
                r = torch.clamp_min(codes, 0)
            else:
                out_c = torch.clamp_min(codes + out_c, 0)
    return out_c.to(torch.int16)


def _to_nhwc(stream, w_img, h_img):
    c, m_total = stream.shape
    return stream.reshape(c, m_total // (w_img * h_img), h_img, w_img).permute(1, 2, 3, 0)


def _from_nhwc(x):
    return x.permute(3, 0, 1, 2).reshape(x.shape[3], -1)


def stage_identity_blocks_reference(stream, wt, scale, bias, ms, g, w_img, h_img):
    """Plain version on the (C, B*H*W) stream of the JAX signature."""
    x = _to_nhwc(stream, w_img, h_img)
    return _from_nhwc(stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, g))


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage_kernel")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stage_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), i, i, i, i, i, i, p]
        lib.stage_launch.restype = i
        lib.stage_smem_bytes.argtypes = [i, i, i]
        lib.stage_smem_bytes.restype = i
        lib._argtypes_set = True
    return lib


def _stage_cuda(x, wt, scale, bias, ms, g):
    batch, h_img, w_img, c = x.shape
    n_blocks = wt.shape[0]
    if x.dtype != torch.int16 or wt.dtype != torch.int8:
        raise TypeError(f"int16 stream and int8 weights expected, got {x.dtype}, {wt.dtype}")
    if c not in CHANNELS:
        raise ValueError(f"the CUDA stage kernel takes C in {CHANNELS}, got {c}")
    if tuple(wt.shape) != (n_blocks, 2, c, 9 * c) or tuple(scale.shape) != (n_blocks, 2, c):
        raise ValueError(f"weights {tuple(wt.shape)} / scale {tuple(scale.shape)} do not fit C={c}")
    if not 0 < n_blocks <= MAX_BLOCKS or not 0 < g <= 127:
        raise ValueError(f"n_blocks={n_blocks} or g={g} out of range")
    x, wt = x.contiguous(), wt.contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    if len({t.device for t in (x, wt, scale, bias)}) != 1:
        raise ValueError("stream, weights, scale and bias must lie on one device")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("K3 needs 16-byte aligned stream and weights")
    plan = _planned(batch, h_img, w_img, c, n_blocks)
    if plan is None and _lib().stage_smem_bytes(c, h_img, w_img) > SMEM_LIMIT:
        raise ValueError(f"a {h_img}x{w_img}x{c} image does not fit one block's shared memory")
    out = torch.empty_like(x)
    if batch:
        _stage_launch(x, out, wt, scale, bias, ms, g, plan)
        _build.launches[KERNEL] += 1
        if plan is not None:
            _build.launches[SM90] += 1
    return out


def _stage_launch(x, out, wt, scale, bias, ms, g, plan: Optional["K3Plan"] = None) -> None:
    """One launch of K3 on NHWC operands the wrapper checked: the Hopper
    form (csrc/stage_kernel_sm90.cu, on the weight re-packed for it) where
    a K3Plan is given, else csrc/stage_kernel.cu. Counts nothing (the
    wrapper does). A launch that fails raises."""
    batch, h_img, w_img, c = x.shape
    ms_arr = (ctypes.c_int * len(ms))(*ms)
    with _build.on_device(x.device):
        cu_stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan is not None:
            magic = (ctypes.c_uint * len(ms))(*(requant_magic(m) for m in ms))
            err = _sm90_lib().k3_sm90_launch(
                x.data_ptr(), out.data_ptr(), _k3_map(wt, plan), scale.data_ptr(), bias.data_ptr(),
                _plan_ints(plan), ms_arr, magic, int(g), cu_stream,
            )
            _build.check(err, "stage_kernel_sm90.cu k3_sm90_kernel")
            return
        err = _lib().stage_launch(
            x.data_ptr(), out.data_ptr(), wt.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), ms_arr, len(ms), int(g), c, h_img, w_img, batch, cu_stream,
        )
    _build.check(err, "stage_kernel.cu stage_kernel")


# ---------------------------------------------------------- the Hopper form

SM90_SMEM = 227 * 1024  # dynamic shared memory an sm_90 block may take
K3_IMGS = (1, 2, 4, 8)  # images a CTA may hold
# the CTAs a launch should keep to hold several images a CTA, or to give a
# 32x32 image fewer than 4 warpgroups: two an SM of the H100's 132
K3_MIN_CTAS = 264
K3_MAX_GROUP = 512  # pixels of a group of several images


class K3Plan(NamedTuple):
    """One launch's plan in K3's Hopper form, in the order of
    csrc/stage_kernel_sm90.cu's Plan.

    The batch's B images run in n_groups groups of `imgs` consecutive
    images, one a CTA of n_wg warpgroups; a group's pixels are the rows of
    its convs' m64 tiles. Each conv's K = 9C padded to KP (a multiple of
    32), its weight in boxes of SWZ bytes of K by C rows in slots of w_slot
    bytes; the group's plane (plane_bytes) comes and goes in TMA boxes of
    BR pixels; each halo buffer is [imgs][(H+2)(W+2)] pixels at P bytes
    (halo_bytes). smem: the bytes the launch asks for."""

    B: int
    H: int
    W: int
    C: int
    n_blocks: int
    imgs: int
    n_groups: int
    n_wg: int
    KP: int
    SWZ: int
    P: int
    BR: int
    w_slot: int
    plane_bytes: int
    halo_bytes: int
    smem: int


K3_PITCH = {16: 16, 32: 32, 64: 96}  # csrc/stage_kernel_sm90.cu Cfg<C>::P
K3_MAX_WG = {16: 4, 32: 4, 64: 2}  # max_threads<C>() / 128


def _k3_layout(b, h, w, c, n_blocks, imgs, n_wg) -> Optional[K3Plan]:
    """The plan at imgs images a CTA and n_wg warpgroups, or None where it
    does not fit the SM or the warpgroups would outnumber a group's tiles."""
    kp = -(-9 * c // 32) * 32
    swz = next(s for s in (128, 64, 32) if kp % s == 0)
    hw = h * w
    if not 1 <= n_wg <= K3_MAX_WG[c] or n_wg > imgs * hw // 64:
        return None
    p = K3_PITCH[c]
    br = next(r for r in (256, 128, 64) if (imgs * hw) % r == 0)
    w_slot = -(-c * kp // (8 * swz)) * 8 * swz
    plane = imgs * hw * 2 * c
    halo = -(-imgs * (h + 2) * (w + 2) * p // 16) * 16
    # the 1024-byte alignment, plane, two weight slots, two halo buffers,
    # the k-word table, three mbarriers
    smem = 1024 + plane + 2 * w_slot + 2 * halo + 4 * (kp // 8) + 24
    if smem > SM90_SMEM:
        return None
    return K3Plan(b, h, w, c, n_blocks, imgs, -(-b // imgs), n_wg, kp, swz, p, br, w_slot, plane, halo, smem)


@functools.lru_cache(maxsize=None)
def k3_plan(b: int, h: int, w: int, c: int, n_blocks: int, imgs: Optional[int] = None,
            n_wg: Optional[int] = None) -> Optional[K3Plan]:
    """The Hopper form's plan of one launch, or None where the form does
    not take the shape (and stage_kernel.cu's form runs it): C in
    CHANNELS, H*W a multiple of 64 (whole m64 tiles an image), 1 to
    MAX_BLOCKS blocks, one image within the SM.

    The rule, from chip_smoke.py --k3-ab over ResNet-20's runs at batches
    2048, 256, 8 and 3 (PERF.md, K3's Hopper form): the most images of
    K3_IMGS whose group holds at most K3_MAX_GROUP pixels, fits the SM and
    still gives K3_MIN_CTAS CTAs, else 1 (several 8x8 and 16x16 images a
    CTA at batch 2048, where each staged weight then serves several
    tiles); 2 warpgroups, or fewer where the group has fewer tiles, and 4
    where the launch has fewer than K3_MIN_CTAS CTAs and a group 16 tiles or
    more (a 32x32 image spread over more warps). imgs and n_wg, where
    given, set them instead (for A/B runs)."""
    if c not in CHANNELS or b < 1 or (h * w) % 64 or not 0 < n_blocks <= MAX_BLOCKS:
        return None
    if imgs is None:
        fit = [i for i in K3_IMGS if i * h * w <= K3_MAX_GROUP and -(-b // i) >= K3_MIN_CTAS
               and _k3_layout(b, h, w, c, n_blocks, i, 1) is not None]
        imgs = max(fit, default=1)
    if n_wg is None:
        tiles = imgs * h * w // 64
        n_wg = min(4 if -(-b // imgs) < K3_MIN_CTAS and tiles >= 16 else 2, tiles, K3_MAX_WG[c])
    return _k3_layout(b, h, w, c, n_blocks, imgs, n_wg)


_OLD_ONLY = False  # set only by _old_form


@contextlib.contextmanager
def _old_form():
    """Every launch inside takes stage_kernel.cu's form. For the A/B
    timing of the two forms (chip_smoke.py --k3-ab); the main path never
    calls it."""
    global _OLD_ONLY
    saved, _OLD_ONLY = _OLD_ONLY, True
    try:
        yield
    finally:
        _OLD_ONLY = saved


def _k3_k_order(c: int) -> np.ndarray:
    """The re-packed weight's columns as indices into the packed (dy, dx,
    c) ones padded to KP (index 9C and up: a zero column): within each
    32-byte K step, wgmma's position kappa takes k(kappa) = 8(kappa//4) +
    kappa%4 for kappa < 16 and 8((kappa-16)//4) + 4 + kappa%4 above, so
    that lane t's A registers a0 and a2 hold the 8 contiguous halo bytes
    k = 8t..8t+7 of its row (as K1's Hopper form, qmatmul._sm90_k_order)."""
    kp = -(-9 * c // 32) * 32
    kappa = np.arange(32)
    k_of = np.where(kappa < 16, 8 * (kappa // 4) + kappa % 4, 8 * ((kappa - 16) // 4) + 4 + kappa % 4)
    return (np.arange(kp).reshape(-1, 32)[:, k_of]).reshape(-1)


# id(wt) -> [a weak reference to wt, its re-packed copy, the copy's tensor
# map]: an entry goes with its weight
_SM90_WEIGHTS: dict = {}


def _k3_weight(wt: torch.Tensor) -> list:
    """The cache entry of wt (n_blocks, 2, C, 9C): its (2 n_blocks C, KP)
    re-packed copy (K zero-padded, then permuted by _k3_k_order) and that
    copy's tensor map, encoded at first use; made once per weight tensor
    and kept while it lives."""
    key = id(wt)
    hit = _SM90_WEIGHTS.get(key)
    if hit is None or hit[0]() is not wt:
        c = wt.shape[-2]
        order = torch.from_numpy(_k3_k_order(c)).to(wt.device)
        flat = torch.nn.functional.pad(wt.reshape(-1, 9 * c), (0, order.numel() - 9 * c))
        hit = [weakref.ref(wt, lambda _, k=key: _SM90_WEIGHTS.pop(k, None)), flat.index_select(1, order).contiguous(),
               None]
        _SM90_WEIGHTS[key] = hit
    return hit


def _k3_map(wt: torch.Tensor, plan: K3Plan):
    """The bytes of the tensor map of wt's re-packed copy in plan's boxes."""
    hit = _k3_weight(wt)
    if hit[2] is None:
        lib = _sm90_lib()
        packed = hit[1]
        wmap = ctypes.create_string_buffer(lib.k3_sm90_map_bytes())
        with _build.on_device(wt.device):
            err = lib.k3_sm90_weight_map(packed.data_ptr(), plan.KP, packed.shape[0], plan.SWZ, plan.C, wmap)
        _build.check(err, "stage_kernel_sm90.cu k3_sm90_weight_map")
        hit[2] = wmap
    return hit[2]


def _sm90_lib() -> ctypes.CDLL:
    lib = _build.load("stage_kernel_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.k3_sm90_launch.argtypes = [p, p, p, p, p, ctypes.POINTER(i), ctypes.POINTER(i),
                                       ctypes.POINTER(ctypes.c_uint), i, p]
        lib.k3_sm90_launch.restype = i
        lib.k3_sm90_weight_map.argtypes = [p, i, i, i, i, p]
        lib.k3_sm90_weight_map.restype = i
        lib.k3_sm90_map_bytes.restype = i
        lib.k3_sm90_plan_ints.restype = i
        if lib.k3_sm90_plan_ints() != len(K3Plan._fields):
            raise RuntimeError("csrc/stage_kernel_sm90.cu's Plan does not match K3Plan")
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _plan_ints(plan):
    return (ctypes.c_int * len(plan))(*plan)


def _planned(batch, h_img, w_img, c, n_blocks) -> Optional[K3Plan]:
    """The plan a CUDA launch takes: k3_plan's, or None (stage_kernel.cu's
    form) under _old_form."""
    return None if _OLD_ONLY else k3_plan(batch, h_img, w_img, c, n_blocks)


def _check_ms(ms, wt):
    ms = tuple(int(m) for m in ms)
    if len(ms) != wt.shape[0] or min(ms) < 1:
        raise ValueError(f"ms {ms} must give one multiplier >= 1 per block")
    return ms


def stage_identity_blocks_nhwc(
    x: torch.Tensor,  # (B, H, W, C) int16 residual-code stream
    wt: torch.Tensor,  # (n_blocks, 2, C, 9C) int8 transposed kernels
    scale: torch.Tensor,  # (n_blocks, 2, C) f32
    bias: torch.Tensor,  # (n_blocks, 2, C) f32
    ms: Sequence[int],  # per-block requant multipliers
    g: int = 127,
) -> torch.Tensor:
    """Run n consecutive identity PreAct blocks on the NHWC code stream, the
    forward's own layout, and return the updated (B, H, W, C) int16 stream:
    K3 on a CUDA tensor, stage_identity_blocks_nhwc_reference on a CPU one."""
    ms = _check_ms(ms, wt)
    if x.device.type == "cpu":
        return stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, g)
    return _stage_cuda(x, wt, scale, bias, ms, g)


def stage_identity_blocks(
    stream: torch.Tensor,  # (C, B*H*W) int16 residual-code stream
    wt: torch.Tensor,  # (n_blocks, 2, C, 9C) int8 transposed kernels
    scale: torch.Tensor,  # (n_blocks, 2, C) f32
    bias: torch.Tensor,  # (n_blocks, 2, C) f32
    ms: Sequence[int],  # per-block requant multipliers
    g: int = 127,
    w_img: int = 32,
    h_img: int = 32,
    chunk_imgs: int = 1,  # images per CTA: the planner's, so only 1 is taken
) -> torch.Tensor:
    """The JAX signature: the same blocks on the (C, B*H*W) stream, which
    it permutes to NHWC and back around stage_identity_blocks_nhwc.

    chunk_imgs is kept from the JAX signature, where it sets the images a
    grid step holds in VMEM. On the card the planner (k3_plan) chooses the
    images a CTA holds, not the caller, so only 1 is taken."""
    if chunk_imgs != 1:
        raise ValueError(f"the CUDA stage kernel runs one image per CTA, got chunk_imgs={chunk_imgs}")
    c, m_total = stream.shape
    if m_total % (w_img * h_img):
        raise ValueError(f"stream width {m_total} is not whole {h_img}x{w_img} images")
    x = _to_nhwc(stream, w_img, h_img)
    return _from_nhwc(stage_identity_blocks_nhwc(x, wt, scale, bias, ms, g))


def pack_block_weights(blocks) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack QConvInt8 conv0/conv1 of identity blocks into the kernel's
    transposed form: HWIO (3,3,C,C) -> W^T (C_out, 9*C_in) with the 9 taps
    in row-major (dy, dx) order."""
    wts, scales, biases = [], [], []
    for blk in blocks:
        convs = [blk["conv0"], blk["conv1"]]
        wts.append(torch.stack([
            q.kernel_int8.permute(3, 0, 1, 2).reshape(q.kernel_int8.shape[3], -1)
            for q in convs
        ]))
        scales.append(torch.stack([q.scale for q in convs]))
        biases.append(torch.stack([q.bias for q in convs]))
    return torch.stack(wts), torch.stack(scales), torch.stack(biases)
