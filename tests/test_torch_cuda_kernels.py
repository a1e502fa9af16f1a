"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc: every test takes the `cuda` fixture, which
skips without one. Imports no JAX, so it runs on a machine with only the
port's dependencies:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

from alignq_tpu_torch.kernels import _build
from alignq_tpu_torch.kernels import quantize as K2
from alignq_tpu_torch.kernels import stage_kernel as K3
from alignq_tpu_torch.kernels.qmatmul import (
    CODES,
    F32,
    FORM,
    NARROW,
    REQUANT,
    SM90,
    TAP_GATHERS,
    _mma_form,
    act_map,
    int8_conv_codes,
    int8_conv_packed,
    int8_conv_reference,
    int8_matmul_codes,
    int8_matmul_codes_reference,
    int8_matmul_dequant,
    int8_matmul_dequant_reference,
    int8_matmul_int32,
    int8_matmul_int32_reference,
    int8_matmul_packed,
    k1_plan,
    narrow_options,
    narrow_plan,
    pack_act_cutpoints,
    pack_conv_weights,
    pack_k1_weights,
    sm90_plan,
)
from alignq_tpu_torch.kernels.stage_kernel import (
    stage_identity_blocks,
    stage_identity_blocks_nhwc,
    stage_identity_blocks_nhwc_reference,
    stage_identity_blocks_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _i8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


def _assert_f32_close(got, want):
    """Bit-identical, but where the plain version's float64 evaluation
    rounds twice at an f32 midpoint: at most 1e-6 of the elements, each
    one ulp away."""
    diff = got != want
    assert diff.sum().item() <= 1e-6 * got.numel()
    w = want[diff]
    up, down = torch.nextafter(w, w + 1), torch.nextafter(w, w - 1)
    assert ((got[diff] == up) | (got[diff] == down)).all()


@pytest.mark.parametrize(
    "m,k,n",
    [(100, 70, 50), (1000, 27, 16), (4099, 144, 32), (300, 16, 32), (257, 576, 64), (130, 288, 128), (64, 32, 200)],
)
def test_qmatmul_vs_plain(cuda, m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w = _i8(rng, (m, k)).to(cuda), _i8(rng, (k, n)).to(cuda)
    s = torch.from_numpy(rng.rand(n).astype(np.float32) * 1e-3).to(cuda)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    assert torch.equal(int8_matmul_int32(x, w), int8_matmul_int32_reference(x, w))
    for relu in (False, True):
        got = int8_matmul_dequant(x, w, s, b, relu=relu)
        want = int8_matmul_dequant_reference(x, w, s, b, relu=relu)
        _assert_f32_close(got, want)
    # a weight packed once, x at its own K (the 1x1 route's operands)
    op = pack_k1_weights(w, s, b)
    _assert_f32_close(int8_matmul_packed(x, op), int8_matmul_dequant_reference(x, w, s, b))
    assert torch.equal(int8_matmul_packed(x, op, "int32"), int8_matmul_int32_reference(x, w))
    torch.cuda.synchronize()


def test_qmatmul_counts_launches(cuda):
    rng = np.random.RandomState(0)
    x, w = _i8(rng, (64, 32)).to(cuda), _i8(rng, (32, 16)).to(cuda)
    before = _build.launches["int8_matmul_dequant"]
    int8_matmul_int32(x, w)
    int8_matmul_dequant(x, w, torch.ones(16, device=cuda))
    assert _build.launches["int8_matmul_dequant"] == before + 2


def _assert_codes_close(got, want):
    """Identical, but where the plain version's float64 evaluation rounds
    twice at an f32 midpoint (or an exp differs in its last bit): at most
    1e-6 of the elements, each one code away."""
    diff = got != want
    assert diff.sum().item() <= 1e-6 * got.numel()
    assert ((got.int() - want.int()).abs() <= 1).all()


@pytest.mark.parametrize("shape", [(1,), (3,), (7, 33, 5), (4099,), (1 << 20, 3), (512, 1024)])
def test_cdf_quantize_vs_plain(cuda, shape):
    rng = np.random.RandomState(len(shape) + shape[0] % 97)
    x = torch.from_numpy((rng.randn(*shape) * 1.5).astype(np.float32)).to(cuda)
    before = _build.launches[K2.KERNEL]
    got = K2.cdf_quantize_int8(x)
    torch.cuda.synchronize()
    assert _build.launches[K2.KERNEL] == before + 1
    assert got.shape == x.shape and got.dtype == torch.int8
    _assert_codes_close(got, K2.cdf_quantize_int8_plain(x))


def test_cdf_quantize_saturates_and_rejects(cuda):
    x = torch.tensor([-100.0, 0.0, 100.0, -0.0, 1e30, -1e30], device=cuda)
    assert K2.cdf_quantize_int8(x).tolist() == [-127, 0, 127, 0, 127, -127]
    with pytest.raises(TypeError):
        K2.cdf_quantize_int8(x.double())
    # a view 4 bytes into its storage is mapped like any other (the wrapper
    # copies it to an aligned buffer)
    base = torch.tensor([7.0, -100.0, 0.0, 100.0, -0.0, 1e30, -1e30, 0.5, -0.5], device=cuda)
    got = K2.cdf_quantize_int8(base[1:])
    assert got.tolist() == [-127, 0, 127, 0, 127, -127, 49, -49]
    assert torch.equal(got, K2.cdf_quantize_int8_plain(base[1:]))


@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (4099, 144, 32), (300, 16, 32), (257, 576, 64), (130, 288, 128)])
@pytest.mark.parametrize("impl,g", [("poly", 127), ("erf", 127), ("bins", 7), ("bins_int", 7)])
def test_qmatmul_codes_vs_plain(cuda, m, k, n, impl, g):
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import act_int_cutpoints

    rng = np.random.RandomState(m + k + n + g)
    x, w = _i8(rng, (m, k)).to(cuda), _i8(rng, (k, n)).to(cuda)
    # h = acc * s + b spread over the act grid, some scales negative
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_k1_weights(w, s, b)
    if impl == "bins_int":
        act = pack_act_cutpoints(act_int_cutpoints(QConvInt8(w, s, b), 4), op.wt.shape[0])
    else:
        act = act_map(impl, g, x.device)
    want = int8_matmul_codes_reference(x, op, act)
    before = (_build.launches[CODES], _build.launches[F32])
    got = int8_matmul_codes(x, op, act)
    torch.cuda.synchronize()
    assert (_build.launches[CODES], _build.launches[F32]) == (before[0] + 1, before[1])
    assert got.shape == (m, n) and got.dtype == torch.int8
    _assert_codes_close(got, want)


@pytest.mark.parametrize(
    "c,h,w,batch,ms,g",
    [
        (16, 8, 8, 4, (2, 3), 127),
        (32, 4, 4, 4, (2, 3), 127),
        (16, 8, 8, 2, (1,), 127),
        (16, 8, 8, 2, (2,), 7),
        (64, 8, 8, 3, (2, 3), 127),
        (16, 32, 32, 2, (1, 2, 3), 127),
    ],
)
def test_stage_kernel_vs_plain(cuda, c, h, w, batch, ms, g):
    rng = np.random.RandomState(c + h + len(ms))
    n = len(ms)
    wt = _i8(rng, (n, 2, c, 9 * c), -20, 20).to(cuda)
    scale = torch.from_numpy(rng.rand(n, 2, c).astype(np.float32) * 1e-3).to(cuda)
    bias = torch.from_numpy((rng.rand(n, 2, c).astype(np.float32) - 0.5) * 0.1).to(cuda)
    stream = torch.from_numpy(rng.randint(0, 4 * g, (c, batch * h * w)).astype(np.int16)).to(cuda)
    before = _build.launches["stage_identity_blocks"]
    got = stage_identity_blocks(stream, wt, scale, bias, ms, g=g, w_img=w, h_img=h)
    torch.cuda.synchronize()
    assert _build.launches["stage_identity_blocks"] == before + 1
    want = stage_identity_blocks_reference(stream, wt, scale, bias, ms, g, w, h)
    assert torch.equal(got, want)


def test_forward_cuda_vs_cpu(cuda):
    from alignq_tpu_torch.kernels.infer import build_resnet20_int8, resnet20_int8_stream

    from alignq_tpu_torch.kernels.infer import pack_int8_operands

    _, (qp_cpu, x_cpu) = build_resnet20_int8(4, device="cpu")
    _, (qp_gpu, x_gpu) = build_resnet20_int8(4, device=cuda)
    kw = dict(act_impl="poly", stream="int16", use_stage_kernel=True, use_pallas_1x1=True)
    want = resnet20_int8_stream(qp_cpu, x_cpu, **kw)
    ops = pack_int8_operands(qp_gpu)
    before = dict(_build.launches)
    got = resnet20_int8_stream(qp_gpu, x_gpu, operands=ops, **kw)
    torch.cuda.synchronize()
    counts = {k: _build.launches[k] - before.get(k, 0)
              for k in ("int8_matmul_dequant", CODES, F32, "stage_identity_blocks", K3.SM90)}
    assert counts == {"int8_matmul_dequant": 7, CODES: 7, F32: 0, "stage_identity_blocks": 3, K3.SM90: 3}
    assert _build.launches[TAP_GATHERS] == before.get(TAP_GATHERS, 0)  # no conv gathered its taps
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize(
    "bits,kw",
    [(8, {"act_impl": "erf"}), (8, {"act_impl": "poly", "fuse_skip": True}), (4, {"act_impl": "bins"}),
     (4, {"act_impl": "bins_int"}), (8, {"act_impl": "erf", "stream": "int8"})],
)
def test_forward_codes_routes_vs_cpu(cuda, bits, kw):
    """Every act site of these routes is K1's codes epilogue on the card;
    the final int16 stream equals the CPU plain path's."""
    from alignq_tpu_torch.kernels.infer import (
        augment_int_cutpoints,
        build_resnet20_int8,
        convert_resnet20,
        resnet20_int8_stream,
    )
    from alignq_tpu_torch.interop import init_preact_resnet_params

    streams = []
    for dev in ("cpu", cuda):
        _, (_, x) = build_resnet20_int8(2, device=dev)
        params, stats = init_preact_resnet_params(20, torch.Generator().manual_seed(1), dev)
        qp = convert_resnet20(params, stats, act_bits=bits)
        if kw["act_impl"] == "bins_int":
            qp = augment_int_cutpoints(qp, bits)
        before = dict(_build.launches)
        streams.append(resnet20_int8_stream(qp, x, act_bits=bits, **kw).cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = _build.launches["int8_matmul_dequant"] - before.get("int8_matmul_dequant", 0)
            assert launched > 0 and _build.launches[CODES] - before.get(CODES, 0) == launched
            assert _build.launches[F32] == before.get(F32, 0)
            assert _build.launches[TAP_GATHERS] == before.get(TAP_GATHERS, 0)
    assert torch.equal(streams[0], streams[1])


# every conv geometry of the serving path: (H, W, Cin, ksize, stride, Cout);
# the last two are fuse_skip's merged conv0 + skip
CONV_GEOMS = [
    (32, 32, 3, 3, 1, 16), (32, 32, 16, 3, 1, 16), (32, 32, 16, 3, 2, 32), (32, 32, 16, 1, 2, 32),
    (16, 16, 32, 3, 1, 32), (16, 16, 32, 3, 2, 64), (16, 16, 32, 1, 2, 64), (8, 8, 64, 3, 1, 64),
    (32, 32, 16, 3, 2, 64), (16, 16, 32, 3, 2, 128),
]


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("geom", CONV_GEOMS)
def test_conv_vs_plain(cuda, geom, batch):
    """K1's conv form on NHWC codes against its plain version (gathered
    taps) in every epilogue mode: one launch each, no gather."""
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import act_int_cutpoints

    h, w, cin, ksize, stride, cout = geom
    pad = 1 if ksize == 3 else 0
    rng = np.random.RandomState(h + cin + ksize + stride + cout + batch)
    x = _i8(rng, (batch, h, w, cin)).to(cuda)
    kern = _i8(rng, (ksize, ksize, cin, cout)).to(cuda)
    k = ksize * ksize * cin
    s = torch.from_numpy(((rng.rand(cout) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(cout) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, b)
    for mode in ("int32", "f32", "relu"):
        before = (_build.launches["int8_matmul_dequant"], _build.launches[TAP_GATHERS])
        got = int8_conv_packed(x, op, stride, pad, mode)
        torch.cuda.synchronize()
        assert (_build.launches["int8_matmul_dequant"], _build.launches[TAP_GATHERS]) == (before[0] + 1, before[1])
        want = int8_conv_reference(x, op, stride, pad, mode)
        assert got.shape == want.shape
        if mode == "int32":
            assert torch.equal(got, want)
        else:
            _assert_f32_close(got, want)
    acts = [act_map("poly", 127, cuda), act_map("erf", 127, cuda), act_map("bins", 7, cuda),
            pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, s, b), 4), op.wt.shape[0])]
    for act in acts:
        before = (_build.launches[CODES], _build.launches[TAP_GATHERS])
        got = int8_conv_codes(x, op, stride, pad, act)
        torch.cuda.synchronize()
        assert (_build.launches[CODES], _build.launches[TAP_GATHERS]) == (before[0] + 1, before[1])
        want = int8_conv_reference(x, op, stride, pad, act.impl, act)
        assert got.shape == want.shape and got.dtype == torch.int8
        _assert_codes_close(got, want)


@pytest.mark.parametrize("c,hw,ms,batch", [(16, 32, (1, 2, 3), 3), (32, 16, (2, 3), 8), (64, 8, (2, 3), 1),
                                           (64, 8, (2,), 8), (32, 4, (2, 3), 3)])
def test_stage_kernel_nhwc_vs_plain(cuda, c, hw, ms, batch):
    rng = np.random.RandomState(c + hw + batch)
    n = len(ms)
    wt = _i8(rng, (n, 2, c, 9 * c), -20, 20).to(cuda)
    scale = torch.from_numpy(rng.rand(n, 2, c).astype(np.float32) * 1e-3).to(cuda)
    bias = torch.from_numpy((rng.rand(n, 2, c).astype(np.float32) - 0.5) * 0.1).to(cuda)
    x = torch.from_numpy(rng.randint(0, 4 * 127, (batch, hw, hw, c)).astype(np.int16)).to(cuda)
    before = _build.launches["stage_identity_blocks"]
    got = stage_identity_blocks_nhwc(x, wt, scale, bias, ms)
    torch.cuda.synchronize()
    assert _build.launches["stage_identity_blocks"] == before + 1
    want = stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, 127)
    assert got.shape == x.shape
    assert torch.equal(got, want)


# K3's Hopper form (csrc/stage_kernel_sm90.cu) at the three widths, with one
# and several images a CTA, 1 to 4 warpgroups, a ragged last group, and a
# run of ResNet-56's 8 blocks (the weights stream through the slots):
# (C, H, batch, ms, imgs, n_wg), imgs and n_wg None where the planner's
STAGE_SM90_FORMS = [
    (16, 32, 3, (1, 2, 3), None, None), (16, 32, 2, (2, 3), 1, 1), (16, 16, 5, (2,), 2, 4),
    (32, 16, 8, (2, 3), None, None), (32, 16, 5, (2, 3), 2, 2), (32, 8, 3, (9,), 4, 4),
    (64, 8, 9, (2, 3), None, None), (64, 8, 9, (2, 3), 4, 2), (64, 8, 3, (1,), 2, 1),
    (64, 8, 6, tuple(range(2, 10)), None, None), (16, 32, 2, tuple(range(2, 10)), None, None),
]


@pytest.mark.parametrize("form", STAGE_SM90_FORMS)
def test_stage_kernel_sm90_vs_plain_and_mma_form(cuda, form):
    """The Hopper form's stream equals the plain version's and the mma.sync
    form's bit for bit; the planner gives it the shape, and its launch is
    counted under stage_identity_blocks and stage_identity_blocks:sm90."""
    c, hw, batch, ms, imgs, n_wg = form
    rng = np.random.RandomState(c + hw + batch + len(ms))
    n = len(ms)
    wt = _i8(rng, (n, 2, c, 9 * c), -20, 20).to(cuda)
    scale = torch.from_numpy(rng.rand(n, 2, c).astype(np.float32) * 1e-3).to(cuda)
    bias = torch.from_numpy((rng.rand(n, 2, c).astype(np.float32) - 0.5) * 0.1).to(cuda)
    x = torch.from_numpy(rng.randint(0, 4 * 127, (batch, hw, hw, c)).astype(np.int16)).to(cuda)
    want = stage_identity_blocks_nhwc_reference(x, wt, scale, bias, ms, 127)
    with K3._old_form():
        old = stage_identity_blocks_nhwc(x, wt, scale, bias, ms)
    if imgs is None:
        before = dict(_build.launches)
        got = stage_identity_blocks_nhwc(x, wt, scale, bias, ms)
        counted = {k: _build.launches[k] - before.get(k, 0) for k in (K3.KERNEL, K3.SM90)}
        assert counted == {K3.KERNEL: 1, K3.SM90: 1}
    else:
        plan = K3.k3_plan(batch, hw, hw, c, n, imgs=imgs, n_wg=n_wg)
        assert plan is not None
        got = torch.empty_like(x)
        K3._stage_launch(x.contiguous(), got, wt.contiguous(), scale, bias, ms, 127, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(old, want)


# K1's forms for DenseNet-40 and MobileNet-V2: (B, H, W, Cin, ksize,
# stride, N) -- 3x3 convs over 200 and more channels (K streamed, the last
# chunk narrower), N above 256 (N blocks), deep 1x1 convs (K streamed)
NEW_K1_FORMS = [
    (2, 8, 8, 448, 3, 1, 12), (3, 16, 16, 304, 3, 1, 12), (2, 8, 8, 336, 3, 1, 12), (1, 16, 16, 224, 3, 1, 12),
    (3, 16, 16, 320, 1, 1, 312), (2, 4, 4, 320, 1, 1, 1280), (3, 4, 4, 160, 1, 1, 960), (3, 4, 4, 960, 1, 1, 160),
    (2, 8, 8, 576, 1, 1, 96), (2, 32, 32, 176, 1, 1, 168), (3, 32, 32, 160, 3, 1, 12),
]


@pytest.mark.parametrize("form", NEW_K1_FORMS)
def test_conv_new_forms_vs_plain(cuda, form):
    """K1's streamed 3x3, N blocks, relu'd codes and int8 requant against
    the plain version: one launch each."""
    b, h, w, cin, ksize, stride, n = form
    pad = ksize // 2
    rng = np.random.RandomState(cin + n + b)
    x = _i8(rng, (b, h, w, cin), 0, 128).to(cuda)
    kern = _i8(rng, (ksize, ksize, cin, n)).to(cuda)
    k = ksize * ksize * cin
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, bias)
    assert torch.equal(int8_conv_packed(x, op, stride, pad, "int32"), int8_conv_reference(x, op, stride, pad, "int32"))
    _assert_f32_close(int8_conv_packed(x, op, stride, pad, "f32"), int8_conv_reference(x, op, stride, pad, "f32"))
    # the stage buffer's requant: scale, then the reciprocal of the slice's scale
    rq = pack_conv_weights(kern, torch.full((n,), 1.3e-4, device=cuda), torch.full((n,), 1.0 / 0.37, device=cuda))
    before = _build.launches[REQUANT]
    got = int8_conv_packed(x, rq, stride, pad, "requant")
    torch.cuda.synchronize()
    assert _build.launches[REQUANT] == before + 1 and got.dtype == torch.int8
    assert torch.equal(got, int8_conv_reference(x, rq, stride, pad, "requant"))
    for act in (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda), act_map("bins", 7, cuda, relu=True)):
        got = int8_conv_codes(x, op, stride, pad, act)
        torch.cuda.synchronize()
        want = int8_conv_reference(x, op, stride, pad, act.impl, act)
        _assert_codes_close(got, want)
        if act.relu:
            assert int(got.min()) >= 0


# K1's forms for the ImageNet-layout ResNet-18/34/50 trunks: (B, H, W, Cin,
# ksize, stride, N) -- the 7x7 stride-2 stem over the image's 3 channels
# (padded to 4; and over 4 channels), 1x1 convs over 1024 and 2048
# channels and to 2048 (K streamed over one-group-a-warp tiles, N blocks),
# the 1x1 stride-2 downsamples, and 3x3 convs of 128 channels and up (K
# streamed, N in blocks of 128) down to 7x7 maps; and 3x3 convs over
# images of 3 (the CIFAR stem), 2 and 1 channels, padded to 4
IMAGENET_K1_FORMS = [
    (2, 224, 224, 3, 7, 2, 64), (3, 64, 64, 3, 7, 2, 64), (1, 30, 37, 3, 7, 2, 64), (2, 20, 21, 4, 7, 2, 64),
    (2, 32, 32, 3, 3, 1, 16), (3, 9, 13, 2, 3, 2, 8), (1, 17, 10, 1, 3, 1, 24),
    (3, 56, 56, 256, 1, 1, 64), (2, 56, 56, 256, 1, 2, 512), (3, 14, 14, 1024, 1, 1, 256),
    (2, 14, 14, 1024, 1, 2, 2048), (3, 7, 7, 2048, 1, 1, 512), (2, 7, 7, 512, 1, 1, 2048),
    (3, 28, 28, 128, 3, 2, 256), (2, 14, 14, 256, 3, 1, 256), (3, 7, 7, 512, 3, 1, 512),
    (2, 14, 14, 512, 3, 2, 512),
]


@pytest.mark.parametrize("form", IMAGENET_K1_FORMS)
def test_conv_imagenet_forms_vs_plain(cuda, form):
    """K1's 7x7 stem form and the trunks' wide 1x1 and streamed 3x3 forms
    against the plain version: int32 identical, f32 and the trunk's act
    codes (erf and poly, relu'd and not) within the plain version's double
    rounding; the kernel's launches gather no taps."""
    b, h, w, cin, ksize, stride, n = form
    pad = ksize // 2
    rng = np.random.RandomState(cin + n + b + ksize)
    x = _i8(rng, (b, h, w, cin), 0 if cin > 3 else -127, 128).to(cuda)
    kern = _i8(rng, (ksize, ksize, cin, n)).to(cuda)
    k = ksize * ksize * cin
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, bias)
    gathers, form = _build.launches[TAP_GATHERS], _build.launches[FORM.format(ksize)]
    got = {"int32": int8_conv_packed(x, op, stride, pad, "int32"), "f32": int8_conv_packed(x, op, stride, pad, "f32")}
    acts = (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda), act_map("erf", 127, cuda))
    codes = [int8_conv_codes(x, op, stride, pad, act) for act in acts]
    torch.cuda.synchronize()
    assert _build.launches[TAP_GATHERS] == gathers and _build.launches[FORM.format(ksize)] == form + 5
    assert torch.equal(got["int32"], int8_conv_reference(x, op, stride, pad, "int32"))
    _assert_f32_close(got["f32"], int8_conv_reference(x, op, stride, pad, "f32"))
    for act, c in zip(acts, codes):
        _assert_codes_close(c, int8_conv_reference(x, op, stride, pad, act.impl, act))


# the IMAGENET_K1_FORMS that K1's Hopper form (csrc/qmatmul_sm90.cu) takes:
# the 1x1 and 3x3 convs over C % 32 == 0 channels to N8 % 64 == 0 columns
SM90_K1_FORMS = [f for f in IMAGENET_K1_FORMS
                 if sm90_plan(*f[:4], f[4], f[5], f[4] // 2, f[6], f[4] ** 2 * f[3]) is not None]


@pytest.mark.parametrize("form", SM90_K1_FORMS)
def test_conv_sm90_form_vs_plain_and_mma_form(cuda, form):
    """K1's Hopper form, which the planner gives these shapes, against the
    plain version (int32 identical, f32 and the act codes within the plain
    version's double rounding) and against the mma.sync form (_mma_form)
    on the same operands, bit for bit in every mode; each launch counted
    under the Hopper form."""
    b, h, w, cin, ksize, stride, n = form
    pad = ksize // 2
    rng = np.random.RandomState(cin + n + b + ksize + 1)
    x = _i8(rng, (b, h, w, cin), 0, 128).to(cuda)
    kern = _i8(rng, (ksize, ksize, cin, n)).to(cuda)
    k = ksize * ksize * cin
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, bias)
    acts = (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda), act_map("erf", 127, cuda),
            act_map("bins", 7, cuda, relu=True))
    got = {}
    for form_ in ("sm90", "mma"):
        before = _build.launches[SM90]
        with _mma_form() if form_ == "mma" else contextlib.nullcontext():
            got[form_] = [int8_conv_packed(x, op, stride, pad, mode) for mode in ("int32", "f32", "relu")] + [
                int8_conv_codes(x, op, stride, pad, act) for act in acts]
        torch.cuda.synchronize()
        assert _build.launches[SM90] == before + (7 if form_ == "sm90" else 0)
    for a, b_ in zip(got["sm90"], got["mma"]):
        assert torch.equal(a, b_)
    assert torch.equal(got["sm90"][0], int8_conv_reference(x, op, stride, pad, "int32"))
    _assert_f32_close(got["sm90"][1], int8_conv_reference(x, op, stride, pad, "f32"))
    for act, c in zip(acts, got["sm90"][3:]):
        _assert_codes_close(c, int8_conv_reference(x, op, stride, pad, act.impl, act))


# K1's narrow Hopper form (csrc/qmatmul_sm90n.cu): ResNet-20's stage-1 conv,
# block-3 skip and block-3 conv1 (which the rule leaves to mma.sync),
# DenseNet-40's growth convs over 48, 176 and 448 channels and its two
# transitions, and a 1x1 over 80 channels to 40: (H, W, Cin, ksize, stride, N)
NARROW_K1_FORMS = [
    (32, 32, 16, 3, 1, 16), (32, 32, 16, 1, 2, 32), (16, 16, 32, 3, 1, 32), (32, 32, 48, 3, 1, 12),
    (16, 16, 176, 3, 1, 12), (8, 8, 448, 3, 1, 12), (32, 32, 176, 1, 1, 168), (16, 16, 320, 1, 1, 312),
    (7, 9, 80, 1, 1, 40),
]


@pytest.mark.parametrize("batch", [8, 3])
@pytest.mark.parametrize("form", NARROW_K1_FORMS)
def test_conv_narrow_form_vs_plain_and_mma_form(cuda, form, batch):
    """K1's narrow Hopper form at its plan (narrow_plan; the planner's
    rule may leave the shape to mma.sync) in every mode (int32, f32, relu,
    requant, the erf, poly, bins and bins_int codes, relu'd and not) against
    the mma.sync form on the same operands, 0 differing elements, by the
    raw launches; where the rule gives it the narrow form, the entry points
    again, each launch counted under the narrow form and held against the
    plain version (int32 and requant identical, f32 and the codes within
    the plain version's double rounding). Then each (MG, WM, WK) option
    that --k1-ab times, bit for bit the rule's output in int32 and poly
    codes."""
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import act_int_cutpoints

    h, w, cin, ksize, stride, n = form
    pad = ksize // 2
    rng = np.random.RandomState(cin + n + batch + ksize + 2)
    x = _i8(rng, (batch, h, w, cin), 0, 128).to(cuda)
    kern = _i8(rng, (ksize, ksize, cin, n)).to(cuda)
    k = ksize * ksize * cin
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(k) * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, bias)
    rq = pack_conv_weights(kern, torch.full((n,), 1.3e-4, device=cuda), torch.full((n,), 1.0 / 0.37, device=cuda))
    geo = (batch, h, w, cin, ksize, stride, pad, *op.wt.shape)
    plan = narrow_plan(*geo)
    assert plan is not None
    mma = K1.conv_plan(*geo)
    acts = (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda), act_map("erf", 127, cuda),
            act_map("bins", 7, cuda, relu=True),
            pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, s, bias), 4), op.wt.shape[0]))
    modes = [(op, m, None) for m in ("int32", "f32", "relu")] + [(rq, "requant", None)] + [
        (op, a.impl, a) for a in acts]
    got = []
    for op_, mode, act in modes:
        a = torch.empty((plan.M, op.wt.shape[0]), device=cuda,
                        dtype={"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8))
        b_ = torch.empty_like(a)
        K1._k1_launch(x, op_, plan, a, mode, act)
        K1._k1_launch(x, op_, mma, b_, mode, act)
        torch.cuda.synchronize()
        assert torch.equal(a, b_), mode
        got.append(a[:, :n].reshape(batch, -1, (w - 1) // stride + 1, n))
    assert torch.equal(got[0], int8_conv_reference(x, op, stride, pad, "int32"))
    _assert_f32_close(got[1], int8_conv_reference(x, op, stride, pad, "f32"))
    assert torch.equal(got[3], int8_conv_reference(x, rq, stride, pad, "requant"))
    for act, c in zip(acts, got[4:]):
        _assert_codes_close(c, int8_conv_reference(x, op, stride, pad, act.impl, act))
    if k1_plan(*geo) == plan:  # the rule's form: through the entry points, counted
        before = _build.launches[NARROW]
        via = [int8_conv_packed(x, op_, stride, pad, mode) if act is None else int8_conv_codes(x, op_, stride, pad, act)
               for op_, mode, act in modes]
        torch.cuda.synchronize()
        assert _build.launches[NARROW] == before + len(modes)
        for a, b_ in zip(via, got):
            assert torch.equal(a, b_)
    for option in narrow_options(op.wt.shape[0]):
        p = narrow_plan(*geo, option=option)
        if p is None:
            continue
        for (op_, mode, act), want in ((modes[0], got[0]), (modes[5], got[5])):
            out = torch.empty((p.M, op.wt.shape[0]), device=cuda, dtype=want.dtype)
            K1._k1_launch(x, op_, p, out, mode, act)
            torch.cuda.synchronize()
            assert torch.equal(out[:, :n].reshape(want.shape), want), option


@pytest.mark.parametrize("batch", [256, 3])
@pytest.mark.parametrize("h,cin,n", [(28, 3, 32), (12, 32, 48)])
def test_conv_digit_forms_vs_plain(cuda, batch, h, cin, n):
    """K1's 5x5 pad-0 form at the digit DANN's two convs (conv1 over the
    image's 3 channels, padded to 4 by the wrapper): int32 identical, f32
    and the relu'd erf and poly codes within the plain version's double
    rounding; 5 launches counted under the 5x5 form, no tap gathered."""
    rng = np.random.RandomState(batch + cin)
    x = _i8(rng, (batch, h, h, cin), -127 if cin == 3 else 0, 128).to(cuda)
    kern = _i8(rng, (5, 5, cin, n)).to(cuda)
    s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(25 * cin) * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32)).to(cuda)
    op = pack_conv_weights(kern, s, bias)
    gathers, form = _build.launches[TAP_GATHERS], _build.launches[FORM.format(5)]
    got = {"int32": int8_conv_packed(x, op, 1, 0, "int32"), "f32": int8_conv_packed(x, op, 1, 0, "f32")}
    acts = (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda, relu=True), act_map("erf", 127, cuda))
    codes = [int8_conv_codes(x, op, 1, 0, act) for act in acts]
    torch.cuda.synchronize()
    assert _build.launches[TAP_GATHERS] == gathers and _build.launches[FORM.format(5)] == form + 5
    assert got["int32"].shape == (batch, h - 4, h - 4, n)
    assert torch.equal(got["int32"], int8_conv_reference(x, op, 1, 0, "int32"))
    _assert_f32_close(got["f32"], int8_conv_reference(x, op, 1, 0, "f32"))
    for act, c in zip(acts, codes):
        _assert_codes_close(c, int8_conv_reference(x, op, 1, 0, act.impl, act))


@pytest.mark.parametrize("c,hw,stride,batch", [(32, 32, 1, 3), (96, 32, 1, 2), (144, 32, 2, 2), (192, 16, 2, 3),
                                               (384, 8, 1, 2), (576, 8, 2, 3), (960, 4, 1, 2), (16, 5, 2, 1),
                                               (4, 8, 1, 1), (4, 9, 2, 2), (100, 11, 1, 1), (20, 7, 2, 1),
                                               (144, 9, 2, 1), (960, 4, 1, 300), (144, 32, 1, 64)])
def test_dw_conv_vs_plain(cuda, c, hw, stride, batch):
    """The depthwise kernel against its plain version in every epilogue, at
    the graph's shapes and the edges: C = 4, C not a multiple of 16 or of
    the chunk, batch 1, odd sizes at stride 2, a full-card plan."""
    from alignq_tpu_torch.kernels import dwconv

    rng = np.random.RandomState(c + hw + stride)
    x = _i8(rng, (batch, hw, hw, c), 0, 128).to(cuda)
    kern = _i8(rng, (3, 3, 1, c)).to(cuda)
    s = torch.from_numpy(((rng.rand(c) * 2 - 0.4) * 2 / (3 * 73.3**2)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(c) * 0.5).astype(np.float32)).to(cuda)
    op = dwconv.pack_dw_weights(kern, s, b)
    before = _build.launches[dwconv.DW]
    got = dwconv.dw_conv(x, op, stride, "int32")
    torch.cuda.synchronize()
    assert _build.launches[dwconv.DW] == before + 1
    assert torch.equal(got, dwconv.dw_conv_reference(x, op, stride, "int32"))
    _assert_f32_close(dwconv.dw_conv(x, op, stride, "f32"), dwconv.dw_conv_reference(x, op, stride, "f32"))
    for act in (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda), act_map("bins", 7, cuda, relu=True),
                act_map("erf", 127, cuda)):
        got = dwconv.dw_conv(x, op, stride, act=act)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and got.shape == (batch, (hw - 1) // stride + 1, (hw - 1) // stride + 1, c)
        _assert_codes_close(got, dwconv.dw_conv_reference(x, op, stride, act=act))


def test_dw_conv_wide_image(cuda):
    """Rows of 400 outputs: runs longer than 8 and bands over 48 KB of
    shared memory."""
    from alignq_tpu_torch.kernels import dwconv

    rng = np.random.RandomState(600)
    x = _i8(rng, (128, 3, 400, 64)).to(cuda)
    op = dwconv.pack_dw_weights(_i8(rng, (3, 3, 1, 64)).to(cuda), torch.ones(64, device=cuda),
                                torch.zeros(64, device=cuda))
    assert dwconv.device_plan(x, 1).smem > 48 * 1024
    got = dwconv.dw_conv(x, op, 1, "int32")
    torch.cuda.synchronize()
    assert torch.equal(got, dwconv.dw_conv_reference(x, op, 1, "int32"))


# MobileNet-V2's depthwise shapes (b, hw, c, stride) at the batches it serves
DW_SM90_SHAPES = [(b, hw, c, s) for b in (256, 8, 3) for hw, c, s in (
    (32, 32, 1), (32, 96, 1), (32, 144, 1), (32, 144, 2), (16, 192, 1), (16, 192, 2), (8, 384, 1), (8, 576, 1),
    (8, 576, 2), (4, 960, 1))]


@pytest.mark.parametrize("b,hw,c,stride", DW_SM90_SHAPES)
def test_dw_sm90_form_vs_plain_and_old_form(cuda, b, hw, c, stride):
    """The depthwise form's Hopper kernel (csrc/dwconv_sm90.cu) against
    csrc/dwconv.cu bit for bit in every mode (int32, f32, erf, poly and
    bins codes, relu'd and not), and against the plain version, at every
    MobileNet-V2 shape at batches 256, 8 and 3; its launches counted."""
    from alignq_tpu_torch.kernels import dwconv

    rng = np.random.RandomState(c + hw + stride + b)
    x = _i8(rng, (b, hw, hw, c), 0, 128).to(cuda)
    kern = _i8(rng, (3, 3, 1, c)).to(cuda)
    s = torch.from_numpy(((rng.rand(c) * 2 - 0.4) * 2 / (3 * 73.3**2)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(c) * 0.5).astype(np.float32)).to(cuda)
    op = dwconv.pack_dw_weights(kern, s, bias)
    assert isinstance(dwconv.device_plan(x, stride), dwconv.DwSm90Plan)
    modes = [("int32", None), ("f32", None)] + [(None, act_map(i, g, cuda, relu=r)) for i, g in (
        ("erf", 127), ("poly", 127), ("erf", 7), ("bins", 7)) for r in (True, False)]
    for mode, act in modes:
        before = _build.launches[dwconv.DW_SM90]
        got = dwconv.dw_conv(x, op, stride, mode or "f32", act)
        with dwconv._old_form():
            old = dwconv.dw_conv(x, op, stride, mode or "f32", act)
        torch.cuda.synchronize()
        assert _build.launches[dwconv.DW_SM90] == before + 1
        if got.dtype == torch.float32:
            assert torch.equal(got.view(torch.int32), old.view(torch.int32))
        else:
            assert torch.equal(got, old)
        want = dwconv.dw_conv_reference(x, op, stride, mode or "f32", act)
        if mode == "int32":
            assert torch.equal(got, want)
        elif mode == "f32":
            _assert_f32_close(got, want)
        else:
            _assert_codes_close(got, want)


@pytest.mark.parametrize("impl,g", [("erf", 127), ("poly", 127), ("erf", 7), ("poly", 7)])
def test_act_table_every_f32(cuda, impl, g):
    """The table form of the map (act_codes.cuh table_code) equals its
    direct map on the card for all 2^32 f32 bit patterns, relu'd and not."""
    from alignq_tpu_torch.kernels import stem

    for relu in (True, False):
        assert stem.act_table_differences(impl, g, relu, cuda) == (0, None)


def _stem_operands(rng, b, hw, windows=None):
    """Images and conv1 whose codes span the relu; windows: the map whose
    non-monotone windows the pooled h are steered into (a faint image,
    scales of 2^-24, biases at the map's irregular steps)."""
    from alignq_tpu_torch.kernels.quantize import act_table_steps

    x = (rng.randn(b, hw, hw, 3) * (0.02 if windows else 1.2)).astype(np.float32)
    k = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    sign = rng.choice([-1, 1], 64)
    if windows:
        wa, wz = act_table_steps(windows, 127)
        irregular = np.nonzero((wz >= wa) & (np.arange(len(wa)) >= 127))[0]
        scale, bias = np.float32(2.0 ** -24) * sign, wa[irregular[np.arange(64) % len(irregular)]]
    else:
        scale, bias = rng.uniform(1e-5, 4e-5, 64) * sign, rng.uniform(-1, 1, 64)
    return (torch.from_numpy(x), pack_conv_weights(torch.from_numpy(k), torch.from_numpy(scale.astype(np.float32)),
                                                   torch.from_numpy(bias.astype(np.float32))))


@pytest.mark.parametrize("b,hw,impl,g,windows", [
    (2, 64, "erf", 127, None), (3, 64, "poly", 127, None), (2, 64, "bins", 7, None), (3, 224, "erf", 127, None),
    (4, 224, "poly", 127, None), (2, 224, "erf", 7, None), (2, 60, "poly", 7, None), (16, 224, "erf", 127, "erf"),
    (16, 224, "poly", 127, "poly")])
def test_stem_kernel_vs_chain(cuda, b, hw, impl, g, windows):
    """The stem kernel (csrc/stem_sm90.cu, after its prep pass) against the
    chain it replaced (K1's 7x7 form and the f16 pool) and the CPU's plain
    chain, bit for bit; with the pooled h steered into the map's windows
    too. One launch of each under its counter."""
    from alignq_tpu_torch.kernels import stem

    x, op = _stem_operands(np.random.RandomState(b + hw + g), b, hw, windows)
    act = act_map(impl, g, cuda, relu=True)
    xg, opg = x.to(cuda), op._replace(wt=op.wt.to(cuda), scale=op.scale.to(cuda), bias=op.bias.to(cuda))
    before = (_build.launches[stem.STEM], _build.launches[stem.PREP])
    got = stem.stem_pool_codes(xg, opg, act)
    torch.cuda.synchronize()
    assert (_build.launches[stem.STEM], _build.launches[stem.PREP]) == (before[0] + 1, before[1] + 1)
    with stem._old_form():
        old = stem.stem_pool_codes(xg, opg, act)
    assert got.dtype == torch.int16 and torch.equal(got, old)
    cpu = stem.stem_pool_codes(x, op, act_map(impl, g, torch.device("cpu"), relu=True))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("ld,c_live,c_out", [(168, 24, 32), (168, 156, 160), (312, 300, 304), (456, 456, 456),
                                             (456, 312, 320), (40, 12, 12), (168, 4, 16), (168, 168, 176),
                                             (44, 20, 24), (48, 44, 44)])
def test_bn_act_codes_vs_plain(cuda, dtype, ld, c_live, c_out):
    """The fused BN-act code kernel over the live prefix of a stage buffer
    (its pitch ld wider than c_live), f32 values or int8 codes, against its
    plain version: codes zero past c_live."""
    rng = np.random.RandomState(ld + c_live + (dtype == torch.int8))
    if dtype == torch.int8:
        x = _i8(rng, (3, 8, 8, ld)).to(cuda)
        s = torch.from_numpy((rng.rand(c_live) * 0.05 + 0.001).astype(np.float32)).to(cuda)
    else:
        x = torch.from_numpy((rng.randn(3, 8, 8, ld) * 1.5).astype(np.float32)).to(cuda)
        s = torch.from_numpy((rng.rand(c_live) * 2 - 0.3).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(c_live) * 0.5).astype(np.float32)).to(cuda)
    for act in (act_map("erf", 127, cuda, relu=True), act_map("poly", 127, cuda, relu=True),
                act_map("bins", 7, cuda, relu=True), act_map("erf", 127, cuda)):
        before = _build.launches[K2.BN_ACT_ARITH]
        got = K2.bn_act_codes(x, c_live, s, b, act, c_out)
        torch.cuda.synchronize()
        assert _build.launches[K2.BN_ACT_ARITH] == before + 1
        assert got.shape == (3, 8, 8, c_out) and got.dtype == torch.int8
        assert not got[..., c_live:].any()
        want = K2.bn_act_codes_plain(x, c_live, s, b, act, c_out)
        _assert_codes_close(got, want)
        if dtype == torch.int8:
            # the table form: built by the arithmetic kernel, then gathered
            table = K2.bn_act_table(s, b, act)
            before = _build.launches[K2.BN_ACT_TABLE]
            got_t = K2.bn_act_codes_table(x, c_live, table, c_out)
            torch.cuda.synchronize()
            assert _build.launches[K2.BN_ACT_TABLE] == before + 1
            assert torch.equal(got_t, got)
            assert torch.equal(got_t, K2.bn_act_codes_table_plain(x, c_live, table, c_out))


@pytest.mark.parametrize("batch", [1, 256])
def test_bn_act_table_vs_plain_at_stage_shapes(cuda, batch):
    """The table form over DenseNet's int8 buffers (pitches 168, 312, 456,
    not multiples of 16) against bn_act_codes_plain, 0 differing codes."""
    rng = np.random.RandomState(batch)
    for hw, ld, c_live in ((32, 168, 168), (16, 312, 228), (8, 456, 444), (8, 456, 312)):
        x = _i8(rng, (batch, hw, hw, ld)).to(cuda)
        s = torch.from_numpy((rng.rand(c_live) * 0.05 + 0.001).astype(np.float32)).to(cuda)
        b = torch.from_numpy((rng.randn(c_live) * 0.5).astype(np.float32)).to(cuda)
        act = act_map("erf", 127, cuda, relu=True)
        got = K2.bn_act_codes_table(x, c_live, K2.bn_act_table(s, b, act), -(-c_live // 16) * 16)
        torch.cuda.synchronize()
        assert torch.equal(got, K2.bn_act_codes_plain(x, c_live, s, b, act, -(-c_live // 16) * 16))


# DenseNet-40's 39 int8-buffer sites: (rows of a batch-1 buffer, c_live, pitch, c_out)
_DN40_SITES = [((32 >> blk) ** 2, c0 + 12 * i, ld, (c0 + 12 * i) if c0 + 12 * i == 456 else -(-(c0 + 12 * i) // 16) * 16)
               for blk, (c0, ld) in enumerate(((24, 168), (168, 312), (312, 456))) for i in range(13)]


@pytest.mark.parametrize("batch", [3, 8])
def test_bn_table_sm90_vs_old_form_and_plain(cuda, batch):
    """The table pass's Hopper kernel (csrc/bn_table_sm90.cu) at every
    DenseNet-40 site, at each batch of work items a warp, bit for bit
    quantize.cu's bn_table_kernel (quantize._old_form) and the plain
    version; each launch counted under its own key (the rule's form:
    the Hopper kernel at c_out <= 64, bn_table_kernel past it)."""
    rng = np.random.RandomState(batch)
    act = act_map("erf", 127, cuda, relu=True)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows, c_live, ld, c_out in _DN40_SITES:
        m = batch * rows
        x = _i8(rng, (m, ld), -128, 128).to(cuda)
        s = torch.from_numpy((rng.rand(c_live) * 0.05 - 0.01).astype(np.float32)).to(cuda)
        b = torch.from_numpy((rng.randn(c_live) * 0.5).astype(np.float32)).to(cuda)
        table = K2.bn_act_table(s, b, act)
        before = (_build.launches[K2.BN_ACT_TABLE_SM90], _build.launches[K2.BN_ACT_TABLE_CHUNKED])
        got = K2.bn_act_codes_table(x, c_live, table, c_out)
        with K2._old_form():
            old = K2.bn_act_codes_table(x, c_live, table, c_out)
        torch.cuda.synchronize()
        taken = c_out <= K2.BN_TABLE_MAX_C_OUT
        assert (_build.launches[K2.BN_ACT_TABLE_SM90], _build.launches[K2.BN_ACT_TABLE_CHUNKED]) == \
            (before[0] + taken, before[1] + 2 - taken)
        assert torch.equal(got, old) and torch.equal(got, K2.bn_act_codes_plain(x, c_live, s, b, act, c_out))
        for items in K2.BN_TABLE_ITEMS:
            out = torch.empty_like(got)
            K2._bn_table_launch(x, c_live, table, out, K2.bn_table_plan(m, ld, c_live, c_out, sms, items=items))
            torch.cuda.synchronize()
            assert torch.equal(out, old), (c_live, ld, items)


def _digit_operands(rng, conv, b, windows=None):
    """A digit conv's input (conv 1: f32 images in [-1, 1]; conv 2: relu'd
    codes) and a weight whose codes span the relu; windows: the map whose
    non-monotone windows the pooled h are steered into (faint inputs,
    scales of 2^-24 or 2^-26, biases at the map's irregular steps)."""
    from alignq_tpu_torch.kernels.quantize import act_table_steps

    cin, n = (3, 32) if conv == 1 else (32, 48)
    if conv == 1:
        x = (rng.uniform(-1, 1, (b, 28, 28, 3)) * (0.03 if windows else 1.0)).astype(np.float32)
    else:
        x = rng.randint(0, 3 if windows else 128, (b, 12, 12, 32)).astype(np.int8)
    k = rng.randint(-127, 128, (5, 5, cin, n)).astype(np.int8)
    sign = rng.choice([-1, 1], n)
    if windows:
        wa, wz = act_table_steps(windows, 127)
        irregular = np.nonzero((wz >= wa) & (np.arange(len(wa)) >= 127))[0]
        scale = np.float32(2.0 ** (-24 if conv == 1 else -26)) * sign
        bias = wa[irregular[np.arange(n) % len(irregular)]]
    else:
        scale = rng.uniform(0.5, 2.0, n) * sign / (127 * np.sqrt(25 * cin) * (1 if conv == 1 else 64))
        bias = rng.uniform(-1, 1, n)
    return (torch.from_numpy(x), pack_conv_weights(torch.from_numpy(k), torch.from_numpy(scale.astype(np.float32)),
                                                   torch.from_numpy(bias.astype(np.float32))))


@pytest.mark.parametrize("conv", [1, 2])
@pytest.mark.parametrize("b,impl,g,windows", [
    (1, "erf", 127, None), (3, "poly", 127, None), (3, "bins", 7, None), (256, "erf", 127, None),
    (257, "poly", 127, None), (64, "erf", 127, "erf"), (64, "poly", 127, "poly")])
def test_digit_kernel_vs_chain(cuda, conv, b, impl, g, windows):
    """The digit kernel (csrc/digit_sm90.cu; conv 1 after its prep pass)
    against the chain it replaced (K1's 5x5 form and the pool,
    digit._old_form) and the CPU's plain chain, bit for bit; with the
    pooled h steered into the map's windows too; at each of the kernel's
    tile options. One launch under its counter."""
    from alignq_tpu_torch.kernels import digit

    x, op = _digit_operands(np.random.RandomState(b + conv + g), conv, b, windows)
    act = act_map(impl, g, cuda, relu=True)
    xg, opg = x.to(cuda), op._replace(wt=op.wt.to(cuda), scale=op.scale.to(cuda), bias=op.bias.to(cuda))
    before = (_build.launches[digit.DIGIT], _build.launches[digit.PREP])
    got = digit.conv_pool(conv, xg, opg, act)
    torch.cuda.synchronize()
    assert (_build.launches[digit.DIGIT], _build.launches[digit.PREP]) == (before[0] + 1, before[1] + (conv == 1))
    with digit._old_form():
        old = digit.conv_pool(conv, xg, opg, act)
    assert got.dtype == torch.int8 and torch.equal(got, old)
    assert torch.equal(got.cpu(), digit.conv_pool(conv, x, op, act_map(impl, g, torch.device("cpu"), relu=True)))
    xin = digit.digit_prep(xg) if conv == 1 else xg
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for img, wg in ((1, 1), (2, 3), (4, 4), (3, 2)):
        out = torch.empty_like(got)
        digit._digit_launch(xin, opg, act, digit.digit_plan(conv, b, sms, img, wg), out)
        torch.cuda.synchronize()
        assert torch.equal(out, old), (img, wg)


@pytest.mark.parametrize("family", ["densenet40 f32", "densenet40 stage_int8", "mobilenetv2"])
def test_family_forward_cuda_vs_cpu(cuda, family):
    """Full-width DenseNet-40 (both buffers) and MobileNet-V2 at batch 3 on
    the card against the CPU plain path, on qparams converted on the CPU:
    every stage buffer / block stream bit for bit, the logits within 1e-5;
    39 K1 and 39 BN-act launches a DenseNet forward (the table form over
    the int8 buffer, its tables built by the first forward; the arithmetic
    form over the f32 one), 50 K1 and 17 depthwise a MobileNet one, no tap
    gathered."""
    from alignq_tpu_torch.kernels import dwconv
    from alignq_tpu_torch.kernels import infer_densenet as D
    from alignq_tpu_torch.kernels import infer_mobilenet as M
    from alignq_tpu_torch.kernels.convert import tree_map

    if family.startswith("densenet"):
        kw = {"stage_int8": family.endswith("stage_int8")}
        _, (qp, x) = D.build_densenet40_int8(3, device="cpu", **kw)
        streams, forward = D.densenet40_int8_buffers, D.densenet40_int8_forward
        ops = D.pack_densenet40_operands
        table = kw["stage_int8"]
        want = {"int8_matmul_dequant": 39, K2.BN_ACT: 39, K2.BN_ACT_TABLE: 39 if table else 0,
                K2.BN_ACT_ARITH: 0 if table else 39, dwconv.DW: 0}
    else:
        kw = {}
        _, (qp, x) = M.build_mobilenetv2_int8(3, device="cpu")
        streams, forward, ops = M.mobilenetv2_int8_streams, M.mobilenetv2_int8_forward, M.pack_mobilenetv2_operands
        want = {"int8_matmul_dequant": 50, K2.BN_ACT: 0, K2.BN_ACT_TABLE: 0, K2.BN_ACT_ARITH: 0, dwconv.DW: 17}
    qg = tree_map(lambda t: t.to(cuda) if torch.is_tensor(t) else t, qp)
    xg, og = x.to(cuda), ops(qg, **kw)
    forward(qg, xg, operands=og, **kw)  # builds the kernels (and the int8 buffer's code tables)
    before = dict(_build.launches)
    lg = forward(qg, xg, operands=og, **kw).cpu()
    counted = {k: _build.launches[k] - before.get(k, 0) for k in (*want, TAP_GATHERS)}
    assert counted == {**want, TAP_GATHERS: 0}
    lc = forward(qp, x, **kw)
    assert torch.isfinite(lg).all() and float((lg - lc).abs().max()) <= 1e-5
    got, ref = list(streams(qg, xg, operands=og, **kw)), list(streams(qp, x, **kw))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g.cpu(), r), f"{family}: stream {i} differs from the CPU's"


# The CIFAR nets' first conv in its kernel (csrc/first_conv_sm90.cu): the
# columns and modes of its sites, (N, mode, relu'd): ResNet-20/56 the
# relu'd codes of every served map (and one map not relu'd), DenseNet-40
# f32 and the stage buffer's requant, MobileNet-V2 the relu'd codes
FIRST_CONV_SITES = [(16, "poly", True), (16, "erf", True), (16, "bins", True), (16, "bins_int", True),
                    (16, "erf", False), (24, "f32", False), (24, "requant", False), (32, "erf", True),
                    (32, "poly", True)]


def _trained_like(acc, rng):
    """Per-column scale and bias of a BN folded over the conv's own sums
    (their mean and std over the batch), with an affine drawn as training
    leaves it: h ~ N(beta, gamma) a column."""
    a = acc.reshape(-1, acc.shape[-1]).double()
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, acc.shape[-1]))
    beta = torch.from_numpy(rng.normal(0.0, 0.3, acc.shape[-1]))
    s = gamma / a.std(0).clamp_min(1.0)
    return s.float(), (beta - a.mean(0) * s).float()


def _window_epilogue(impl, n, rng):
    """Scales of 2^-24 and biases at the map's irregular steps, so that h
    lies in the table's windows (act_codes.cuh table_code's slow path)."""
    from alignq_tpu_torch.kernels.quantize import act_table_steps

    wa, wz = act_table_steps(impl, 127)
    irregular = np.nonzero((wz >= wa) & (np.arange(len(wa)) >= 127))[0]
    scale = np.float32(2.0 ** -24) * rng.choice([-1, 1], n)
    return torch.from_numpy(scale.astype(np.float32)), torch.from_numpy(wa[irregular[np.arange(n) % len(irregular)]])


def _close(got, want, mode):
    if mode in ("int32", "requant"):
        assert torch.equal(got, want), mode
    elif got.dtype == torch.float32:
        _assert_f32_close(got, want)
    else:
        _assert_codes_close(got, want)


@pytest.mark.parametrize("weights", ["random", "trained", "windows"])
@pytest.mark.parametrize("batch", [1, 3, 8, 256, 2048])
def test_first_conv_kernel_vs_plain_and_chain(cuda, batch, weights):
    """The first-conv kernel through its entry point (one launch each,
    counted) from f32 images, at every site's columns and modes, against the
    chain it replaced (linear_q, K1's pad pass and mma.sync form, under
    first_conv._old_form) bit for bit and against its plain version; at
    random weights, trained-like ones (a BN folded over the conv's own sums)
    and with h steered into the erf and poly maps' windows. At 2048 the
    main path's relu'd poly and erf codes."""
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import S_IMG, act_int_cutpoints

    rng = np.random.RandomState(batch + len(weights))
    x = torch.from_numpy((rng.randn(batch, 32, 32, 3) * (0.02 if weights == "windows" else 1.2)).astype(np.float32))
    x = x.to(cuda)
    for n, mode, relu in FIRST_CONV_SITES:
        if batch == 2048 and (n != 16 or mode not in ("poly", "erf") or not relu):
            continue
        if weights == "windows" and mode not in ("poly", "erf"):
            continue
        kern = _i8(rng, (3, 3, 3, n)).to(cuda)
        if weights == "random":
            s = torch.from_numpy(rng.uniform(2e-5, 1.2e-4, n).astype(np.float32) * rng.choice([-1, 1], n))
            b = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32))
        elif weights == "trained":
            acc = FC.first_conv_reference(x, pack_conv_weights(kern), S_IMG, mode="int32")
            s, b = _trained_like(acc.cpu(), rng)
        else:
            s, b = _window_epilogue(mode, n, rng)
        op = pack_conv_weights(kern, s.to(cuda), b.to(cuda))
        act = None
        if mode == "requant":
            op = op._replace(bias=torch.full((n,), 1.0 / 0.037, device=cuda))
        elif mode == "bins_int":
            act = pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, op.scale[:n], op.bias[:n]), 4),
                                     op.wt.shape[0])._replace(relu=relu)
        elif mode != "f32":
            act = act_map(mode, 7 if mode == "bins" else 127, cuda, relu=relu)
        before = _build.launches[FC.FIRST]
        got = FC.first_conv(x, op, S_IMG, act, mode)
        torch.cuda.synchronize()
        assert _build.launches[FC.FIRST] == before + 1
        with FC._old_form():
            old = FC.first_conv(x, op, S_IMG, act, mode)
        if got.dtype == torch.float32:
            assert torch.equal(got.view(torch.int32), old.view(torch.int32)), (n, mode)
        else:
            assert torch.equal(got, old), (n, mode, relu)
        _close(got, FC.first_conv_reference(x, op, S_IMG, act, mode), mode)
        if weights != "windows" and mode not in ("f32", "requant"):
            assert len(torch.unique(got)) > 3  # codes spread over the grid


# K1's plane form (csrc/qmatmul_sm90p.cu) at its shapes on the main path:
# block 3's stride-2 conv0 and the 16x16 3x3s to 32 columns (ResNet-20/56),
# and the narrower forms it also takes: (H, W, Cin, stride, N)
PLANE_K1_FORMS = [(32, 32, 16, 2, 32), (16, 16, 32, 1, 32), (16, 16, 16, 1, 16), (32, 32, 16, 2, 16),
                  (32, 32, 16, 1, 16)]


@pytest.mark.parametrize("weights", ["random", "trained", "windows"])
@pytest.mark.parametrize("batch", [1, 3, 8, 256, 2048])
@pytest.mark.parametrize("form", PLANE_K1_FORMS)
def test_conv_plane_form_vs_plain_and_mma_form(cuda, form, batch, weights):
    """K1's plane form at its plan in every mode (int32, f32, relu,
    requant, the erf, poly, bins and bins_int codes, relu'd and not; at 2048
    int32 and the site maps' poly and erf codes) against the mma.sync form
    on the same operands, 0 differing elements, by the raw launches, and
    against the plain version; where the rule gives it the plane form, the
    entry points again, each launch counted under PLANE; then each item
    size (whole images, halves, quarters), bit for bit the rule's output. At random weights, trained-like
    ones and with h steered into the maps' windows."""
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels.convert import QConvInt8
    from alignq_tpu_torch.kernels.infer import act_int_cutpoints

    h, w, cin, stride, n = form
    rng = np.random.RandomState(cin + n + batch + stride + len(weights))
    x = _i8(rng, (batch, h, w, cin), *((0, 2) if weights == "windows" else (0, 128))).to(cuda)
    kern = _i8(rng, (3, 3, cin, n)).to(cuda)
    if weights == "random":
        s = torch.from_numpy(((rng.rand(n) * 2 - 0.4) * 2 / (np.sqrt(9 * cin) * 73.3**2)).astype(np.float32))
        b = torch.from_numpy((rng.randn(n) * 0.5).astype(np.float32))
    elif weights == "trained":
        s, b = _trained_like(int8_conv_reference(x, pack_conv_weights(kern), stride, 1, "int32").cpu(), rng)
    else:
        s, b = _window_epilogue("erf" if batch % 2 else "poly", n, rng)
    op = pack_conv_weights(kern, s.to(cuda), b.to(cuda))
    rq = op._replace(bias=torch.full((n,), 1.0 / 0.37, device=cuda))
    geo = (batch, h, w, cin, 3, stride, 1, *op.wt.shape)
    plan = K1.plane_plan(*geo)
    assert plan is not None
    mma = K1.conv_plan(*geo)
    acts = [act_map(i, 127, cuda, relu=r) for i in ("erf", "poly") for r in (False, True)]
    if batch != 2048:
        cut = pack_act_cutpoints(act_int_cutpoints(QConvInt8(kern, op.scale[:n], op.bias[:n]), 4), op.wt.shape[0])
        acts += [act_map("bins", 7, cuda, relu=True), cut, cut._replace(relu=True)]
    modes = [(op, "int32", None)] + [(op, a.impl, a) for a in acts] + (
        [(op, "f32", None), (op, "relu", None), (rq, "requant", None)] if batch != 2048 else [])
    got = []
    for op_, mode, act in modes:
        a = torch.empty((plan.B * plan.Ho * plan.Wo, n), device=cuda,
                        dtype={"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8))
        b_ = torch.empty_like(a)
        K1._k1_launch(x, op_, plan, a, mode, act)
        K1._k1_launch(x, op_, mma, b_, mode, act)
        torch.cuda.synchronize()
        assert torch.equal(a, b_), (mode, act.relu if act is not None else None)
        a = a.reshape(batch, plan.Ho, plan.Wo, n)
        _close(a, int8_conv_reference(x, op_, stride, 1, mode, act), mode)
        got.append(a)
    if k1_plan(*geo) == plan:  # the rule's form: through the entry points, counted
        before = _build.launches[K1.PLANE]
        via = [int8_conv_packed(x, op_, stride, 1, mode) if act is None else int8_conv_codes(x, op_, stride, 1, act)
               for op_, mode, act in modes]
        torch.cuda.synchronize()
        assert _build.launches[K1.PLANE] == before + len(modes)
        for a, b_ in zip(via, got):
            assert torch.equal(a, b_)
    for rows in K1.plane_rows(plan.Ho, plan.Wo):
        p = K1.plane_plan(*geo, rows=rows)
        if p is None or p == plan:
            continue
        for (op_, mode, act), want in ((modes[0], got[0]), (modes[2], got[2])):
            out = torch.empty((batch * plan.Ho * plan.Wo, n), device=cuda, dtype=want.dtype)
            K1._k1_launch(x, op_, p, out, mode, act)
            torch.cuda.synchronize()
            assert torch.equal(out.reshape(want.shape), want), rows
