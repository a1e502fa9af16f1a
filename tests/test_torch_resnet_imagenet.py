"""The ImageNet-layout ResNet trunks of alignq_tpu_torch
(models/resnet_imagenet.py, kernels/infer_resnet_imagenet.py, the
resnet18/34/50 deploy families) and K1's forms for them, on the CPU,
against the JAX package.

- QAT: ResNet-18 and ResNet-50 at 64x64, batch 2, W4A4 with ADMM, flax's
  init carried across at f64 (its BatchNorm affine drawn with numpy): the
  train forward's feature, every parameter gradient of a loss on it and
  the sites' D, the new BatchNorm statistics and D itself within 1e-9.
  JAX runs eagerly (under jit XLA contracts the dequant multiply and the
  residual add, and the exact-zero residual ties take the other relu
  branch).
- stage 'align' at 32-bit activations: ResNet-18's train and eval
  forwards equal jitted flax's within 1e-9.
- The max pool's gradient on tied inputs (zeros, equal codes, overlapping
  windows, the -inf padding) equals flax's exactly.
- INT8: convert_resnet_imagenet folded at f64 equals JAX's leaf for leaf;
  resnet_imagenet_int8_forward for erf and poly: every stage's codes (the
  block inputs, the last act sites, the integer stream) and the f32 stream
  bit-identical to jitted JAX's stage by stage; the features within 1e-5
  relative of the whole jitted forward, or 1e-7 of its largest feature
  (its spatial mean sums in another order, and its fusions round some of
  the f32 stream's multiply-adds twice, where the port's one FMA leaves an
  exact cancellation's residual: 7.5e-9 against 0 on these inputs).
- _dynamic_q and _dynamic_q_codes at engineered ties equal jitted JAX's.
- K1's plain version of the 7x7 stride-2 stem equals
  lax.conv_general_dilated's int32; the trunks' K1 plans cover every
  output once, and their index math, emulated, computes the conv.
- JAX-saved resnet18/34/50 artifacts served by the port's
  engine_from_artifact within 1e-5 of the JAX engine.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import affine_bn_tree, emulate_k1, f64_tree, flat_names, random_like, to_port_layout

from alignq_tpu.admm.loss import admm_loss
from alignq_tpu.kernels import artifact as jart
from alignq_tpu.kernels import infer as JI
from alignq_tpu.kernels import infer_resnet_imagenet as JR
from alignq_tpu.models import resnet_imagenet as JM
from alignq_tpu.train.state import flatten_site_names
from alignq_tpu_torch import interop
from alignq_tpu_torch.admm.loss import admm_loss as t_admm_loss
from alignq_tpu_torch.kernels import qmatmul as K1
from alignq_tpu_torch.kernels import infer_resnet_imagenet as TR
from alignq_tpu_torch.kernels.deploy_registry import DEPLOY_FAMILIES
from alignq_tpu_torch.models import resnet_imagenet as TM
from alignq_tpu_torch.serve import engine_from_artifact

TOL = dict(rtol=1e-9, atol=1e-9)
HW = 64

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------------- QAT


@pytest.mark.parametrize("arch,n_sites", [("resnet18", 8), ("resnet50", 16)])
def test_qat_trunk_matches_flax_at_f64(arch, n_sites):
    x = np.random.RandomState(0).randn(2, HW, HW, 3)
    with jax.enable_x64(True):
        jm = getattr(JM, f"{arch}_quant")(4, 4, admm=True)
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
        params = affine_bn_tree(f64_tree(jax.device_get(v["params"])))
        stats = f64_tree(jax.device_get(v["batch_stats"]))
        feat_dim = jax.eval_shape(lambda a: jm.apply(v, a), jnp.zeros((1, HW, HW, 3))).shape[-1]
        g = np.random.RandomState(1).randn(2, feat_dim)

        def loss_fn(p):
            feat, nv = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, compute_corr=True,
                                mutable=["batch_stats", "admm_d"])
            ds = flatten_site_names(nv["admm_d"])
            loss = jnp.sum(feat * g)
            for i, n in enumerate(sorted(ds)):
                r = np.random.RandomState(100 + i)
                loss = loss + admm_loss(ds[n], jnp.asarray(r.rand(2, 2)), jnp.asarray(r.rand(2, 2)))
            return loss, (feat, nv["batch_stats"], ds)

        (loss, (feat, new_stats, ds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, params))
        loss, feat, grads, new_stats, ds = jax.device_get((loss, feat, grads, new_stats, ds))

    tm = getattr(TM, f"{arch}_quant")(4, 4, admm=True).double()
    own = sorted([n for n, _ in tm.named_parameters()] + [n for n, _ in tm.named_buffers()])
    assert own == sorted({**flat_names(params), **flat_names(stats)})
    interop.load_flax_tree(tm, params, stats)
    sink = {}
    feat_t = tm(torch.tensor(x), train=True, sink=sink)
    loss_t = (feat_t * torch.tensor(g)).sum()
    for i, n in enumerate(sorted(sink)):
        r = np.random.RandomState(100 + i)
        loss_t = loss_t + t_admm_loss(sink[n], torch.tensor(r.rand(2, 2)), torch.tensor(r.rand(2, 2)))
    named = dict(tm.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))

    assert sorted(sink) == sorted(ds) and len(ds) == n_sites
    assert all(n.endswith(("act_q2/d", "act_q3/d")) for n in ds)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss), **TOL)
    np.testing.assert_allclose(feat_t.detach().numpy(), feat, **TOL)
    for n in ds:
        np.testing.assert_allclose(sink[n].detach().numpy(), ds[n], **TOL, err_msg=n)
    want = flat_names(grads)
    for n, gt in grads_t.items():
        scale = max(np.abs(want[n]).max(), 1.0)
        np.testing.assert_allclose(gt.numpy() / scale, to_port_layout(n, want[n]) / scale, **TOL, err_msg=n)
    want = flat_names(new_stats)
    for n, s in tm.named_buffers():
        np.testing.assert_allclose(s.numpy(), want[n], **TOL, err_msg=n)


@pytest.mark.parametrize("train", [False, True])
def test_align_stage_trunk_matches_flax(train):
    """stage='align' at 32-bit activations (the DA presets' FP32 stage):
    every act site applies the CDF transform unrounded; ResNet-18 at
    32x32, batch 2, f64, against jitted flax (no rounding, so no tie for
    XLA's contracted multiply-adds to move) within 1e-9."""
    x = np.random.RandomState(3).randn(2, 32, 32, 3)
    kw = dict(bitW=4, abitW=32, stage="align")
    with jax.enable_x64(True):
        jm = JM.resnet18_quant(**kw)
        v = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
        params = affine_bn_tree(f64_tree(jax.device_get(v["params"])))
        stats = f64_tree(jax.device_get(v["batch_stats"]))
        want = jax.jit(lambda p, a: jm.apply({"params": p, "batch_stats": stats}, a, train=train,
                                             mutable=["batch_stats"] if train else False))(params, jnp.asarray(x))
        want = np.asarray(want[0] if train else want)
    tm = TM.resnet18_quant(**kw).double()
    interop.load_flax_tree(tm, params, stats)
    got = tm(torch.tensor(x), train=train).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = TM.resnet18_quant(bitW=4, abitW=32).double()
    interop.load_flax_tree(plain, params, stats)
    assert not np.allclose(plain(torch.tensor(x), train=train).detach().numpy(), got)  # the transform is applied


def test_max_pool_gradient_on_tied_inputs():
    """flax's nn.max_pool (reduce_window max, -inf padding) and
    F.max_pool2d give each window's gradient to the same element: the first
    maximum in row-major order, on inputs full of ties (small integers,
    whole zero planes, negatives against the padding)."""
    rng = np.random.RandomState(2)
    x = rng.randint(-2, 3, (3, 9, 10, 5)).astype(np.float64)
    x[1] = 0.0
    x[2, :, :, 1] = 1.0
    g = rng.randn(3, 5, 5, 5)
    with jax.enable_x64(True):
        def f(a):
            return jnp.sum(fnn.max_pool(a, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))) * g)

        want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = F.max_pool2d(xt, 3, 2, 1)
    (out * torch.tensor(g.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy().transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(out.detach().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                                          padding=((1, 1), (1, 1)))))


# ------------------------------------------------------------------- INT8


@functools.lru_cache(maxsize=None)
def _trees(arch, seed=3):
    return random_like(interop.init_resnet_imagenet_params(arch, torch.Generator().manual_seed(0), "cpu"), seed)


@functools.lru_cache(maxsize=None)
def _jax_qparams(arch, act_bits=8):
    params, stats = _trees(arch)
    return jax.jit(functools.partial(JR.convert_resnet_imagenet, weight_bits=8, act_bits=act_bits))(params, stats)


def _port_qparams(jq):
    return interop.qparams_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_convert_folded_at_f64_equals_jax(arch):
    """Both sides fold at f64 (at f32 the weight CDF's mean and std sum in
    XLA's host-dependent order: tests/test_torch_convert.py): the codes,
    and the f32 scale and bias that fold_conv_bn casts once, equal."""
    params, stats = _trees(arch)
    as64 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
    with jax.enable_x64(True):
        jq = jax.device_get(jax.jit(JR.convert_resnet_imagenet)(as64(params), as64(stats)))
    tq = TR.convert_resnet_imagenet(*interop.params_from_numpy(as64(params), as64(stats), "cpu"))
    pairs = [(jq["conv1"], tq["conv1"])]
    assert len(jq["layers"]) == len(tq["layers"])
    for jb, tb in zip(jq["layers"], tq["layers"]):
        assert sorted(jb) == sorted(tb)
        pairs += [(jb[k], tb[k]) for k in jb]
    for jc, tc in pairs:
        np.testing.assert_array_equal(tc.kernel_int8.numpy(), np.asarray(jc.kernel_int8))
        np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
        np.testing.assert_array_equal(tc.bias.numpy(), np.asarray(jc.bias))


def _jax_stages(jq, x, act_bits, impl):
    """The stages of JAX's resnet_imagenet_int8_forward, as
    resnet_imagenet_int8_streams yields them: the stem's pooled codes, then
    each block's input codes, last act codes and output stream. Each piece
    is jitted as the whole forward's HLO fuses it: the downsample's
    `acc * (scale * s_in) + bias` and the stream's `relu(a * act_scale +
    identity)` each within one fusion (one FMA apiece). A graph that
    materializes the block's codes beside its output (a jit of the whole
    block) rounds the stream's multiply-add twice instead."""
    act_scale = 2.0 / JI._act_g(act_bits)

    @jax.jit
    def stem(q, a):
        h = JR._conv(JI._linear_q(a, JI.S_IMG), q, 2, 3)
        c = jnp.maximum(JI._erfq_codes(h, act_bits, impl).astype(jnp.int16), 0)
        return jax.lax.reduce_window(c, jnp.int16(jnp.iinfo(jnp.int16).min), jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1), [(0, 0), (1, 1), (1, 1), (0, 0)])

    @functools.partial(jax.jit, static_argnums=2)
    def requant(out_c, out_f, codes_stream):
        return JR._dynamic_q_codes(out_c, act_scale) if codes_stream else JR._dynamic_q(out_f)

    @functools.partial(jax.jit, static_argnums=3)
    def last_codes(blk, x8, s_in, stride):
        if "conv3" in blk:
            r = jnp.maximum(JI._erfq_codes(JR._conv(x8, blk["conv1"], 1, 0, s_in), act_bits, impl), 0)
            r = jnp.maximum(JI._erfq_codes(JR._conv(r.astype(jnp.int8), blk["conv2"], stride, 1), act_bits, impl), 0)
            h = JR._conv(r.astype(jnp.int8), blk["conv3"], 1, 0)
        else:
            r = jnp.maximum(JI._erfq_codes(JR._conv(x8, blk["conv1"], stride, 1, s_in), act_bits, impl), 0)
            h = JR._conv(r.astype(jnp.int8), blk["conv2"], 1, 1)
        return JI._erfq_codes(h, act_bits, impl).astype(jnp.int16)

    downsample = jax.jit(JR._conv, static_argnums=(2, 3))
    add_f = jax.jit(lambda a, ident: jax.nn.relu(a.astype(jnp.float32) * act_scale + ident))
    add_c = jax.jit(lambda a, ident: jnp.maximum(a + ident, 0))

    out = stem(jq["conv1"], x)
    stages = [{"out": np.asarray(out)}]
    out_c, out_f = out, jnp.zeros((), jnp.float32)
    for i, blk in enumerate(jq["layers"]):
        stride = 2 if ("downsample" in blk and i > 0) else 1
        x8, s_in = requant(out_c if out_c is not None else jnp.zeros((), jnp.int16), out_f, out_c is not None)
        a = last_codes(blk, x8, s_in, stride)
        if "downsample" in blk:
            out_c, out_f = None, add_f(a, downsample(x8, blk["downsample"], stride, 0, s_in))
        elif out_c is not None:
            out_c = add_c(a, out_c)
        else:
            out_f = add_f(a, out_f)
        stages.append({"in": np.asarray(x8), "last": np.asarray(a),
                       "out": np.asarray(out_c if out_c is not None else out_f)})
    return stages


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("impl", ["erf", "poly"])
def test_int8_trunk_stages_equal_jitted_jax(arch, impl):
    jq = _jax_qparams(arch)
    x = np.random.RandomState(7).randn(2, HW, HW, 3).astype(np.float32)
    want = _jax_stages(jq, x, 8, impl)
    tq = _port_qparams(jq)
    got = list(TR.resnet_imagenet_int8_streams(tq, torch.from_numpy(x), act_impl=impl))
    assert len(got) == len(want) == 1 + len(jq["layers"])
    # ResNet-18's layer1 keeps the integer stream; ResNet-50's first block has a downsample
    assert (want[1]["out"].dtype == np.int16) == (arch == "resnet18") and want[-1]["out"].dtype == np.float32
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert sorted(g_) == sorted(w_)
        for k in w_:
            t = g_[k].numpy()
            assert t.dtype == w_[k].dtype, (i, k)
            np.testing.assert_array_equal(t, w_[k], err_msg=f"stage {i} {k}")
    feat = TR.resnet_imagenet_int8_forward(tq, torch.from_numpy(x), act_impl=impl).numpy()
    ref = np.asarray(jax.jit(functools.partial(JR.resnet_imagenet_int8_forward, act_impl=impl))(jq, x))
    assert feat.shape == ref.shape == (2, 512 if arch == "resnet18" else 2048)
    np.testing.assert_allclose(feat, ref, rtol=1e-5, atol=1e-7 * np.abs(ref).max())


def test_int8_trunk_impls_jax_refuses():
    jq = _jax_qparams("resnet18")
    with pytest.raises(ValueError, match="bins_int"):
        list(TR.resnet_imagenet_int8_streams(_port_qparams(jq), torch.zeros(1, 32, 32, 3), act_impl="bins_int"))
    with pytest.raises(ValueError, match="A4/A2"):  # bins is the A4/A2 grids' map, as in JAX
        list(TR.resnet_imagenet_int8_streams(_port_qparams(jq), torch.zeros(1, 32, 32, 3), act_impl="bins"))


def test_int8_trunk_a4_bins_equals_jitted_jax():
    jq = _jax_qparams("resnet18", act_bits=4)
    x = np.random.RandomState(8).randn(2, 32, 32, 3).astype(np.float32)
    want = _jax_stages(jq, x, 4, "bins")
    got = list(TR.resnet_imagenet_int8_streams(_port_qparams(jq), torch.from_numpy(x), act_bits=4, act_impl="bins"))
    for i, (g_, w_) in enumerate(zip(got, want)):
        for k in w_:
            np.testing.assert_array_equal(g_[k].numpy(), w_[k], err_msg=f"stage {i} {k}")


def test_dynamic_q_at_engineered_ties_equals_jitted_jax():
    """_dynamic_q: the scale is max|x| times f32(1/127) (a constant's
    reciprocal), the codes a true division; inputs at (k + 1/2) * s put
    every code on a rounding tie. _dynamic_q_codes: exact integers, K_max
    of 2g saturating every odd K onto a half."""
    rng = np.random.RandomState(4)
    for m in rng.uniform(0.5, 9.0, 40).astype(np.float32):
        s = np.float32(m) * np.float32(1.0 / 127.0)
        x = ((np.arange(-126, 126) + 0.5) * np.float64(s)).astype(np.float32)
        x = np.concatenate([x, [m, -m / 3]]).astype(np.float32).reshape(1, 2, -1, 1)
        jc, js = jax.jit(JR._dynamic_q)(x)
        tc, ts = TR._dynamic_q(torch.from_numpy(x))
        assert ts.dtype == torch.float32 and float(ts) == float(js)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for act_bits in (8, 4):
        g = int(JI._act_g(act_bits))
        for kmax in (1, 2, 2 * g, 2 * g - 1, 3 * g):
            k = rng.randint(-kmax, kmax + 1, (2, 3, 5, 4)).astype(np.int16)
            k[0, 0, 0, 0] = kmax
            jc, js = jax.jit(lambda a: JR._dynamic_q_codes(a, 2.0 / g))(k)
            tc, ts = TR._dynamic_q_codes(torch.from_numpy(k), 2.0 / g)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            assert float(ts) == float(js)
    zeros = torch.zeros((1, 2, 2, 3), dtype=torch.int16)
    assert float(TR._dynamic_q_codes(zeros, 2.0 / 127)[1]) == float(jax.jit(
        lambda a: JR._dynamic_q_codes(a, 2.0 / 127))(np.zeros((1, 2, 2, 3), np.int16))[1])


# ------------------------------------------------------------------- K1


def _stem_operands(rng, b, h, w):
    x = rng.randint(-127, 128, (b, h, w, 3)).astype(np.int8)
    k = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    return x, k


@pytest.mark.parametrize("b,h,w", [(2, 64, 64), (1, 30, 37), (1, 8, 130)])
def test_stem_plain_conv_equals_lax_int32(b, h, w):
    rng = np.random.RandomState(h + w)
    x, k = _stem_operands(rng, b, h, w)
    want = jax.jit(lambda a, kk: jax.lax.conv_general_dilated(
        a, kk, (2, 2), [(3, 3), (3, 3)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))(x, k)
    op = K1.pack_conv_weights(torch.from_numpy(k))
    assert op.cin == 4 and op.wt.shape == (64, 224)
    got = K1.int8_conv_packed(torch.from_numpy(x), op, 2, 3, "int32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _trunk_convs(arch, b, hw):
    """(B, H, W, Cin, ksize, stride, N) of every K1 launch of a trunk."""
    out = [(b, hw, hw, 4, 7, 2, 64)]
    h = ((hw - 1) // 2) // 2 + 1
    bott = arch == "resnet50"
    inp = 64
    for s, (planes, n) in enumerate(zip((64, 128, 256, 512), {"resnet18": (2, 2, 2, 2)}.get(arch, (3, 4, 6, 3)))):
        for i in range(n):
            st = (1 if s == 0 else 2) if i == 0 else 1
            ho = (h - 1) // st + 1
            if bott:
                out += [(b, h, h, inp, 1, 1, planes), (b, h, h, planes, 3, st, planes),
                        (b, ho, ho, planes, 1, 1, 4 * planes)]
            else:
                out += [(b, h, h, inp, 3, st, planes), (b, ho, ho, planes, 3, 1, planes)]
            if i == 0 and (st != 1 or inp != planes * (4 if bott else 1)):
                out.append((b, h, h, inp, 1, st, planes * (4 if bott else 1)))
            inp, h = planes * (4 if bott else 1), ho
    return out


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
@pytest.mark.parametrize("batch", [3, 256])
def test_trunk_plans_cover_every_output_once(arch, batch):
    """Every K1 launch of the trunk at 224x224 (ResNet-18: 20, ResNet-34:
    36, ResNet-50: 53): a plan within the budget, a streamed warp holding
    one 32-row group, every output of every N block written once."""
    convs = _trunk_convs(arch, batch, 224)
    assert len(convs) == {"resnet18": 20, "resnet34": 36, "resnet50": 53}[arch]
    for b, h, w, c, ks, st, n in set(convs):
        p = K1.conv_plan(b, h, w, c, ks, st, ks // 2, n, K1._round_up(ks * ks * c, K1.K_MULT))
        assert p.smem <= K1.SMEM_BUDGET and 32 * p.warps_m * p.warps_n <= 256 and p.NB <= K1.N_MAX
        assert p.n_blocks * p.NB >= p.N8 > (p.n_blocks - 1) * p.NB
        assert p.n_chunks == 1 or p.warps_m == p.TR * p.TW // 32
        tiles = np.arange(p.n_tiles)
        tx, rest = tiles % p.tiles_x, tiles // p.tiles_x
        bb, ty = rest // p.tiles_y, rest % p.tiles_y
        i = np.arange(p.TR * p.TW)
        oy, ox = (ty * p.TR)[:, None] + i // p.TW, (tx * p.TW)[:, None] + i % p.TW
        m = ((bb[:, None] * p.Ho + oy) * p.Wo + ox)[(oy < p.Ho) & (ox < p.Wo)]
        assert np.array_equal(np.bincount(m, minlength=p.B * p.Ho * p.Wo), np.ones(p.B * p.Ho * p.Wo))


# (B, H, W, Cin, ksize, stride, N): the forms the trunks add to K1 -- the
# 7x7 stem (one-row tiles of 64 at stride 2) over the image's 3 channels
# padded to 4 (and over 4), 1x1 convs over 1024 and 2048 channels and to
# 2048 (streamed over one-group tiles, N blocks), the 1x1 stride-2
# downsamples, 3x3 convs from 128 channels (streamed, N in blocks of 128)
# down to 7x7 maps -- and 3x3 convs over images of 3 (the CIFAR stem), 2
# and 1 channels, padded to 4
IMAGENET_FORMS = [
    (1, 8, 130, 3, 7, 2, 64), (1, 30, 37, 3, 7, 2, 64), (2, 9, 11, 4, 7, 2, 64), (2, 32, 32, 3, 3, 1, 16),
    (3, 9, 13, 2, 3, 2, 8), (1, 17, 10, 1, 3, 1, 24),
    (1, 56, 56, 256, 1, 1, 64), (1, 14, 14, 1024, 1, 2, 2048), (1, 7, 7, 2048, 1, 1, 512),
    (1, 7, 7, 512, 1, 1, 2048), (1, 28, 28, 128, 3, 2, 256), (1, 7, 7, 512, 3, 1, 512),
]


@pytest.mark.parametrize("form", IMAGENET_FORMS)
def test_k1_imagenet_forms_emulated(form):
    """Each form's plan run through csrc/qmatmul.cu's index math in numpy
    (tests/torch_port_helpers.py emulate_k1) computes the int32 conv."""
    b, h, w, cin, ksize, stride, n = form
    rng = np.random.RandomState(cin + n)
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8))
    op = K1.pack_conv_weights(torch.from_numpy(rng.randint(-127, 128, (ksize, ksize, cin, n)).astype(np.int8)))
    xin = K1._conv_input(x, op)
    plan = K1.conv_plan(*xin.shape, ksize, stride, ksize // 2, *op.wt.shape)
    if cin >= 512 or (ksize == 3 and cin >= 128):
        assert plan.n_chunks > 1
    got = emulate_k1(xin, op, plan)
    want = K1.int8_conv_reference(x, op, stride, ksize // 2, "int32").reshape(-1, n)
    np.testing.assert_array_equal(got[:, :n], want.numpy())


# ------------------------------------------------------------- serving


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_jax_saved_artifact_served_by_the_port(tmp_path, arch):
    """An artifact the JAX package saves (meta: the family, 64x64 images,
    erf) loads into the port's template, and the port's engine answers the
    pooled feature within 1e-5 (relative to the largest) of jitted JAX's
    forward on the engine's batches: the block inputs' scale is the batch's
    max, so the second request is held to JAX's forward of it padded with
    zeros to the engine batch, as the engine runs it."""
    jq = _jax_qparams(arch)
    path = str(tmp_path / f"{arch}.npz")
    jart.save_int8_artifact(path, jq, meta={"model": arch, "act_bits": 8, "weight_bits": 8, "act_impl": "erf",
                                            "image_size": HW})
    x = np.random.RandomState(9).randn(3, HW, HW, 3).astype(np.float32)
    engine = engine_from_artifact(path, batch_size=2, device="cpu")
    try:
        assert engine.input_shape == (HW, HW, 3)
        got = np.concatenate([engine.submit(x[:2]).result(timeout=300), engine.submit(x[2:]).result(timeout=300)])
    finally:
        engine.close()
    fwd = jax.jit(JR.resnet_imagenet_int8_forward)
    want = np.concatenate([np.asarray(fwd(jq, x[:2])), np.asarray(fwd(jq, np.concatenate([x[2:], 0 * x[:1]])))[:1]])
    assert got.shape == want.shape == (3, 512 if arch != "resnet50" else 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_imagenet_families_in_the_registry():
    """Each trunk family converts the port's own tree into the template's
    structure, takes its request shape from the meta (224 by default) and
    refuses nothing; the domain-adaptation families on the trunk serve
    from the same meta keys (arch, image_size) with the trunk's template
    under 'trunk'."""
    meta = {"model": "resnet34", "image_size": 96}
    fam = DEPLOY_FAMILIES["resnet34"]
    assert fam.input_shape(meta) == (96, 96, 3) and fam.input_shape({"model": "resnet50"}) == (224, 224, 3)
    tq = fam.template(meta, "cpu")
    assert len(tq["layers"]) == 16 and "downsample" in tq["layers"][3] and "conv3" not in tq["layers"][0]
    ops = fam.operands(tq, meta)
    assert ops["conv1"].ksize == 7 and ops["conv1"].cin == 4
    da = DEPLOY_FAMILIES["dann"]
    tda = da.template({"model": "dann", "arch": "resnet34", "image_size": 96}, "cpu")
    assert da.input_shape(meta) == (96, 96, 3) and len(tda["trunk"]["layers"]) == 16
    assert sorted(tda["heads"]) == ["class_classifier", "domain_classifier"]
    assert tda["heads"]["class_classifier"]["kernel"].shape == (512, 31)
