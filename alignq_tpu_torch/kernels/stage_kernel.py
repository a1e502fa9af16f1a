"""Stage-interior megakernel for the INT8 PreAct ResNet graph (kernel K3).

Port of alignq_tpu/kernels/stage_kernel.py. `stage_identity_blocks_nhwc`
runs n consecutive stride-1 identity blocks on the int16 residual code
stream in the forward's own layout, (B, H, W, C). On a CUDA tensor it
launches csrc/stage_kernel.cu, which keeps each image's stream plane in
shared memory through all n blocks and runs the convs on the tensor
cores; on a CPU tensor it runs the plain version,
`stage_identity_blocks_nhwc_reference`, whose convs accumulate in float64
(exact: every partial sum is an integer below 2^53).
`stage_identity_blocks` keeps the JAX signature, (C, B*H*W), around it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels.qmatmul import gather_taps, int8_matmul_int32_reference
from alignq_tpu_torch.quant.cdf import erf_sqrt2, fma_f32

KERNEL = "stage_identity_blocks"  # launch-counter key
CHANNELS = (16, 32, 64)  # the widths csrc/stage_kernel.cu is instantiated for
MAX_BLOCKS = 32
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def _poly_codes(h: torch.Tensor, g: float) -> torch.Tensor:
    """round(poly_cdf(h) * g) codes as int32, kernels/infer.py's
    _erfq_codes(impl='poly') before its int8 cast."""
    c = erf_sqrt2(h, "poly")
    return torch.clamp(torch.round(c * g), -g, g).to(torch.int32)


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
    lib = _lib()
    if lib.stage_smem_bytes(c, h_img, w_img) > SMEM_LIMIT:
        raise ValueError(f"a {h_img}x{w_img}x{c} image does not fit one block's shared memory")
    out = torch.empty_like(x)
    if batch:
        _stage_launch(x, out, wt, scale, bias, ms, g)
        _build.launches[KERNEL] += 1
    return out


def _stage_launch(x, out, wt, scale, bias, ms, g) -> None:
    """One launch of csrc/stage_kernel.cu on NHWC operands the wrapper
    checked. Counts nothing (the wrapper does)."""
    batch, h_img, w_img, c = x.shape
    ms_arr = (ctypes.c_int * len(ms))(*ms)
    with _build.on_device(x.device):
        cu_stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().stage_launch(
            x.data_ptr(), out.data_ptr(), wt.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), ms_arr, len(ms), int(g), c, h_img, w_img, batch, cu_stream,
        )
    _build.check(err, "stage_kernel.cu stage_kernel")


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
    chunk_imgs: int = 1,  # images per CTA: fixed at 1 here
) -> torch.Tensor:
    """The JAX signature: the same blocks on the (C, B*H*W) stream, which
    it permutes to NHWC and back around stage_identity_blocks_nhwc.

    chunk_imgs is kept from the JAX signature, where it sets the images a
    grid step holds in VMEM. The CUDA kernel always gives one image to a
    CTA, so only 1 is taken."""
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
