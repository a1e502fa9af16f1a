"""Shared inputs of the tests/test_torch_*.py files."""

import os

import numpy as np
import pytest
import torch

from alignq_tpu_torch import interop


def random_preact_tree(depth, seed):
    """A flax-layout PreActResNet (params, batch_stats) of the given depth,
    every leaf drawn with numpy: fan-in-scaled uniform kernels and
    non-trivial BN scale, shift, mean and variance."""
    return random_like(interop.init_preact_resnet_params(depth, torch.Generator().manual_seed(0), "cpu"), seed)


def random_densenet_tree(depth, seed, stage_int8=False):
    """A flax-layout DenseNet (params, batch_stats), drawn as
    random_like draws; with stage_int8 the StageRequant amax too."""
    shapes = interop.init_densenet_params(depth, torch.Generator().manual_seed(0), "cpu", stage_int8=stage_int8)
    return random_like(shapes, seed)


def random_mobilenet_tree(seed):
    """A flax-layout MobileNet-V2 (params, batch_stats), drawn as
    random_like draws."""
    return random_like(interop.init_mobilenetv2_params(torch.Generator().manual_seed(0), "cpu"), seed)


def random_like(trees, seed):
    """(params, batch_stats) of the shapes of `trees`, every leaf drawn with
    numpy: fan-in-scaled uniform kernels, non-trivial BN scale, shift, mean
    and variance, StageRequant amax uniform in [2, 6]."""
    shapes, stat_shapes = trees
    rng = np.random.RandomState(seed)

    def draw(tree):
        out = {}
        for k, v in tree.items():
            shape = tuple(v.shape) if torch.is_tensor(v) else None
            if shape is None:
                out[k] = draw(v)
            elif k == "kernel":
                out[k] = (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = (rng.rand(*shape) + 0.5).astype(np.float32)
            elif k == "amax":
                out[k] = (rng.rand(*shape) * 4 + 2).astype(np.float32)
            else:  # bias, mean
                out[k] = (rng.randn(*shape) * 0.2).astype(np.float32)
        return out

    return draw(shapes), draw(stat_shapes)


def affine_bn_tree(params, seed=5):
    """A flax-layout params tree with every BatchNorm scale drawn in [0.7,
    1.3] and bias N(0, 0.2) with numpy. At flax's init (bias 0) uniform
    weight and act grids make a conv output equal its channel's batch
    mean, so the BN output is an ulp either side of 0 by the mean's
    summation order, under a relu, and two libraries branch apart."""
    rng = np.random.RandomState(seed)

    def draw(tree, bn):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = draw(v, "bn" in k)
            elif bn and k == "scale":
                out[k] = rng.uniform(0.7, 1.3, np.shape(v))
            elif bn and k == "bias":
                out[k] = rng.randn(*np.shape(v)) * 0.2
            else:
                out[k] = v
        return out

    return draw(params, False)


def f64_tree(tree):
    """A nested dict with every floating leaf as float64 numpy."""
    if isinstance(tree, dict):
        return {k: f64_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def flat_names(tree, prefix=""):
    """A nested dict -> {'a.b.c': numpy leaf}, the port's parameter names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_names(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def to_port_layout(name, a):
    """A flax leaf in the port's layout: conv kernels (and LLSQ's alpha_w)
    HWIO -> OIHW."""
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if (name.endswith("kernel") or name.endswith("alpha_w")) and a.ndim == 4 else a


def write_tiny_cifar10(data_dir, per_batch=16, n_test=64, seed=0):
    """CIFAR-10's python pickles (five train batches and a test batch) of
    a few seeded random images under data_dir/cifar-10-batches-py, so that
    a loader or a trainer runs on the cifar10 path in a second."""
    import os
    import pickle

    base = os.path.join(str(data_dir), "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = n_test if name == "test_batch" else per_batch
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8), b"labels": list(rng.randint(0, 10, n))}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)
    return str(data_dir)


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test, restored after: the
    suite runs several test processes at once, and eager PyTorch on small
    tensors gains nothing from threads that then contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def site_duals(names, b):
    """(alter_d, gamma) B x B numpy duals of each ADMM site, by sorted name."""
    out = {}
    for i, n in enumerate(sorted(names)):
        r = np.random.RandomState(100 + i)
        out[n] = (r.rand(b, b), r.rand(b, b))
    return out


def flax_train_step(jm, params, stats, x, y, jit=False):
    """One JAX train forward with every ADMM site collected and the
    gradient of CE + the sites' ADMM losses (site_duals): (loss, logits,
    grads, new batch_stats, {site: D}) as numpy. Eager unless jit: under
    jit XLA contracts multiply-adds, which moves a residual sum that is an
    exact zero under a relu (PreActResNet) off its tie."""
    import jax
    import jax.numpy as jnp
    import optax

    from alignq_tpu.admm.loss import admm_loss
    from alignq_tpu.train.state import flatten_site_names

    def loss_fn(p):
        logits, nv = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, compute_corr=True,
                              mutable=["batch_stats", "admm_d"])
        ce = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)))
        ds = flatten_site_names(nv.get("admm_d", {}))
        duals = site_duals(ds, x.shape[0])
        trans = 0.0
        for n in sorted(ds):
            trans = trans + admm_loss(ds[n], jnp.asarray(duals[n][0]), jnp.asarray(duals[n][1]))
        return ce + trans, (logits, nv["batch_stats"], ds)

    step = jax.value_and_grad(loss_fn, has_aux=True)
    (loss, (logits, new_stats, ds)), grads = (jax.jit(step) if jit else step)(jax.tree.map(jnp.asarray, params))
    return jax.device_get((loss, logits, grads, new_stats, ds))


def port_train_step(tm, x, y):
    """The port's counterpart of flax_train_step on its model: (loss,
    logits, {name: grad}, {site: D}) as tensors."""
    from alignq_tpu_torch.admm.loss import admm_loss

    sink = {}
    logits = tm(torch.tensor(x), train=True, sink=sink)
    duals = site_duals(sink, x.shape[0])
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    for n in sorted(sink):
        loss = loss + admm_loss(sink[n], torch.tensor(duals[n][0]), torch.tensor(duals[n][1]))
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return loss, logits, grads, sink


def assert_train_step_matches(want, got, tm, tol):
    """flax_train_step's results against port_train_step's, and the new
    statistics (BatchNorm's, StageRequant's amax) against tm's buffers."""
    loss, logits, grads, new_stats, ds = want
    loss_t, logits_t, grads_t, sink = got
    assert sorted(sink) == sorted(ds)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss), **tol)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits), **tol)
    for n in ds:
        np.testing.assert_allclose(sink[n].detach().numpy(), np.asarray(ds[n]), **tol, err_msg=n)
    want_g = flat_names(grads)
    assert set(want_g) == set(grads_t)
    for n, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), to_port_layout(n, want_g[n]), **tol, err_msg=n)
    want_s = flat_names(new_stats)
    assert set(want_s) == {n for n, _ in tm.named_buffers()}
    for n, s in tm.named_buffers():
        np.testing.assert_allclose(s.numpy(), want_s[n], **tol, err_msg=n)


def assert_qparams_match(jq, tq):
    """A qparams tree converted by the JAX package against the port's, leaf
    by leaf in JAX's order: weight codes within one code on under 1e-3 of
    them (the CDF's mean and std reduce in another order:
    tests/test_torch_convert.py), f32 leaves within an f32 rounding."""
    import jax

    from alignq_tpu_torch.kernels.artifact import _leaves

    jl_all = jax.tree.leaves(jq)
    tl_all = [leaf for _, leaf in _leaves(tq)]
    assert len(jl_all) == len(tl_all)
    for jl, tl in zip(jl_all, tl_all):
        jl, tl = np.asarray(jl), (tl.detach().cpu().numpy() if torch.is_tensor(tl) else np.asarray(tl))
        assert jl.shape == tl.shape and jl.dtype == tl.dtype
        if jl.dtype == np.int8:
            assert np.abs(jl.astype(int) - tl.astype(int)).max() <= 1
            assert (jl != tl).mean() < 1e-3
        else:
            np.testing.assert_allclose(tl, jl, rtol=2e-6, atol=1e-7)


def emulate_k1(x, op, plan) -> np.ndarray:
    """csrc/qmatmul.cu's index math in numpy, int32 mode: for each N block
    and tile, each stage's band and (where K streams) weight chunk filled as
    issue_stage fills them, over stale bytes; the K loop's fragment words
    through the k-word tables; the tile's accumulators written to its
    output rows. Returns the (M, N8) output (-2**40 where nothing wrote).
    Where K streams, each warp must hold one 32-row group of the tile (its
    accumulators persist over the chunks)."""
    p = plan
    xn, wt = x.numpy(), op.wt.numpy()
    out = np.full((p.B * p.Ho * p.Wo, p.N8), -(2**40), np.int64)
    ps = p.stride if p.ksize > 1 else 1
    ls = 1 if p.ksize > 1 else p.stride
    ks, taps = p.ksize, p.ksize * p.ksize
    if p.n_chunks > 1:
        assert p.TR * p.TW == 32 * p.warps_m
    ccl = p.C - (p.n_chunks - 1) * p.CC
    last_words = p.KC // 4 if p.n_chunks > 1 else 0
    koff = []
    for q in range(last_words + p.KCL // 4 if ks > 1 else 0):
        last = q >= last_words
        cc = ccl if last else p.CC
        tap, c = divmod(4 * (q - last_words if last else q), cc)
        koff.append((tap // ks) * p.RP + (tap % ks) * p.P + c if tap < taps else (ks - 1) * (p.RP + p.P) + cc - 4)
    assert 4 * len(koff) <= p.koff_bytes
    koff = np.array(koff)
    rng = np.random.RandomState(0)
    i = np.arange(p.TR * p.TW)
    ro, co = i // p.TW, i % p.TW
    base = ro * ps * p.RP + co * ps * p.P
    for nb in range(p.n_blocks):
        n0 = nb * p.NB
        nbr = min(p.NB, p.N8 - n0)
        assert nbr > 0 and nbr % 8 == 0 and 32 * p.warps_n >= nbr and p.warps_m * p.warps_n <= 8
        if p.n_chunks == 1:
            wres = rng.randint(-128, 128, max(p.w_bytes, 1)).astype(np.int8)
            for n in range(nbr):
                wres[n * p.WP : n * p.WP + p.Kp] = wt[n0 + n]
        for tile in range(p.n_tiles):
            tx, rest = tile % p.tiles_x, tile // p.tiles_x
            b, oy0, ox0 = rest // p.tiles_y, (rest % p.tiles_y) * p.TR, tx * p.TW
            iy0 = oy0 * p.stride - (p.pad if ks > 1 else 0)
            ix0 = ox0 * p.stride - (p.pad if ks > 1 else 0)
            acc = np.zeros((p.TR * p.TW, nbr), np.int64)
            for chunk in range(p.n_chunks):
                buf = rng.randint(-128, 128, p.stage_bytes).astype(np.int8)  # stale bytes
                c0 = chunk * p.CC
                cc = min(p.CC, p.C - c0)
                assert cc % p.vec == 0 and p.P % p.vec == 0 and p.RP % p.vec == 0
                for r in range(p.HR):
                    for cp in range(p.HC):
                        iy, ix = iy0 + r * ls, ix0 + cp * ls
                        inside = 0 <= iy < p.H and 0 <= ix < p.W
                        at = r * p.RP + cp * p.P
                        assert at + cc <= p.a_bytes
                        buf[at : at + cc] = xn[b, iy, ix, c0 : c0 + cc] if inside else 0
                last = chunk == p.n_chunks - 1
                kc = p.KCL if last else p.KC
                if p.n_chunks == 1:
                    wm = wres
                else:
                    wm = buf[p.a_bytes :]
                    for n in range(nbr):
                        row = n * p.WP
                        if p.ksize == 1:
                            wm[row : row + kc] = wt[n0 + n, c0 : c0 + kc]
                        else:
                            for tap in range(taps):
                                src = tap * p.C + c0
                                wm[row + tap * cc : row + (tap + 1) * cc] = wt[n0 + n, src : src + cc]
                            wm[row + taps * cc : row + kc] = 0
                    assert p.a_bytes + nbr * p.WP <= p.stage_bytes
                kt = koff[last_words:] if last and p.n_chunks > 1 else koff
                words = np.arange(kc // 4)
                offs = kt[words] if ks > 1 else 4 * words
                a_idx = base[:, None, None] + offs[None, :, None] + np.arange(4)[None, None, :]
                assert a_idx.max() < p.a_bytes
                a = buf[a_idx.reshape(len(base), -1)].astype(np.int64)
                w = wm[np.arange(nbr)[:, None] * p.WP + np.arange(kc)[None, :]].astype(np.int64)
                acc += a @ w.T
            oy, ox = oy0 + ro, ox0 + co
            ok = (oy < p.Ho) & (ox < p.Wo)
            rows = (b * p.Ho + oy[ok]) * p.Wo + ox[ok]
            assert (out[rows, n0 : n0 + nbr] == -(2**40)).all()  # each output once
            out[rows, n0 : n0 + nbr] = acc[ok]
    assert (out != -(2**40)).all()  # every output written
    return out


def record_dropout_masks(masks):
    """A flax method interceptor that runs every train-mode nn.Dropout as
    flax does (one make_rng, bernoulli(keep) over the broadcast shape) and
    appends its mask, as numpy, to `masks` in call order. The rng must be
    concrete (JAX run eagerly)."""
    import flax.linen as fnn
    import jax

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = fnn.module.merge_param("deterministic", mod.deterministic, kwargs.get("deterministic"))
        if det or mod.rate in (0.0, 1.0):
            return next_fun(*args, **kwargs)
        x = args[0]
        rng = mod.make_rng(mod.rng_collection)
        shape = [1 if d in mod.broadcast_dims else n for d, n in enumerate(x.shape)]
        masks.append(np.asarray(jax.random.bernoulli(rng, 1.0 - mod.rate, shape)))
        return next_fun(*args, **{**kwargs, "rng": rng})

    return fnn.intercept_methods(interceptor)


def port_masks(masks):
    """JAX's recorded dropout masks in the port's layout (an NHWC
    channel mask (B, 1, 1, C) as NCHW (B, C, 1, 1)), as an iterator of
    bool tensors: the rng a port train step takes."""
    return iter([torch.from_numpy(np.array(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m)) for m in masks])


def flax_da_init(jm, hw, *init_args, seed=0):
    """f64 (params with every BatchNorm affine drawn, batch_stats) of a
    flax DA model, its init jitted."""
    import jax
    import jax.numpy as jnp

    init = jax.jit(lambda k, x: jm.init(k, x, *init_args, train=False))
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3)))
    return affine_bn_tree(f64_tree(jax.device_get(v["params"]))), f64_tree(jax.device_get(v["batch_stats"]))


# ------------------------------------------------- data-parallel test ranks
#
# The data-parallel tests run the port's ranks as subprocesses joined over
# gloo on the CPU (torch only: no JAX in a rank), as tests/test_multihost.py
# runs JAX's. A rank runs dist_worker() on a JSON spec and writes its
# results to spec["out"] (an .npz, "{rank}" filled in).

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)


def run_ranks(n, spec, tmp_path, timeout=240):
    """Run `n` ranks of dist_worker on `spec` (one process when n == 1);
    returns each rank's output. A rank that fails or outlasts `timeout`
    fails the test, and every rank is stopped."""
    import json
    import subprocess
    import sys

    from alignq_tpu_torch.entry import free_port

    path = str(tmp_path / f"spec_{spec['kind']}_{n}_{free_port()}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {**os.environ, "PYTHONPATH": REPO_DIR, "OMP_NUM_THREADS": "1", "ALIGNQ_DIST_TIMEOUT": str(timeout)}
    env.pop("XLA_FLAGS", None)
    code = f"import sys; sys.path.insert(0, {TESTS_DIR!r}); import torch_port_helpers as h; h.dist_worker()"
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), port, path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {r} of {n} exited {p.returncode}:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def tiny_images(n=32, hw=8, seed=0, classes=10):
    """Seeded numpy images (n, hw, hw, 3) f32 and labels."""
    r = np.random.RandomState(seed)
    return r.randn(n, hw, hw, 3).astype(np.float32), r.randint(0, classes, n)


def state_arrays(state):
    """A train state as flat numpy arrays: p: params, b: statistics,
    a:/g: each site's duals, t: momentum traces, and the step."""
    out = {f"p:{k}": v.detach().cpu().numpy() for k, v in state.params.items()}
    out.update({f"b:{k}": v.detach().cpu().numpy() for k, v in state.batch_stats.items()})
    for k, s in state.admm_duals.items():
        out[f"a:{k}"], out[f"g:{k}"] = s.alter_d.cpu().numpy(), s.gamma.cpu().numpy()
    out.update({f"t:{k}": v.detach().cpu().numpy() for k, v in state.tx.trace.items()})
    out["step"] = np.array(state.step)
    return out


def load_state_arrays(state, arrays, rank=None):
    """state_arrays' p:, b:, a: and g: entries into `state` in place (a
    local-mode rank takes its own [rank] of (N, B/N, B/N) duals)."""
    from alignq_tpu_torch.admm.state import ADMMSiteState

    with torch.no_grad():
        for table, tag in ((state.params, "p"), (state.batch_stats, "b")):
            for k, v in table.items():
                v.copy_(torch.from_numpy(np.array(arrays[f"{tag}:{k}"])))
    duals = {}
    for k in [key[2:] for key in arrays if key.startswith("a:")]:
        a, g = np.array(arrays[f"a:{k}"]), np.array(arrays[f"g:{k}"])
        if rank is not None:
            a, g = a[rank], g[rank]
        dt = next(state.model.parameters()).dtype
        duals[k] = ADMMSiteState(torch.from_numpy(a).to(dt), torch.from_numpy(g).to(dt))
    if duals:
        state.admm_duals = duals


def _preact(spec, gen):
    from alignq_tpu_torch.models.resnet_cifar import PreActResNet

    return PreActResNet(num_units=(1, 1, 1), w_bit=spec["bits"], a_bit=spec["bits"], admm=spec["admm"],
                        method=spec.get("method", "ours"), generator=gen).double()


def _cfg(spec, n, **kw):
    from alignq_tpu_torch.train.config import TrainConfig

    base = dict(bitW=spec["bits"], abitW=spec["bits"], admm=spec["admm"], method=spec.get("method", "ours"),
                train_batch_size=8, eval_batch_size=8, num_epochs=1, lr=0.02, print_freq=1,
                job_dir=spec.get("job", "job"),
                mesh_shape=(n,), mesh_axes=("data",), corr_mode=spec.get("mode", "gather"),
                grad_compression=spec.get("compression", "f32"), seed=3, lr_decay_steps=(1000,))
    base.update(kw)
    return TrainConfig(**base)


def _worker_fit(rank, n, spec):
    """A classification fit of a depth-8 PreActResNet in float64 on 8x8
    images; with spec['restore'] it then restores the checkpoint just
    written into a fresh state and returns that one too (r: keys)."""
    from alignq_tpu_torch.data.loader import ArrayLoader, Data
    from alignq_tpu_torch.train.loop import fit

    x, y = tiny_images(32 if not spec.get("restore") else 16)
    data = Data(ArrayLoader(x, y, 8, shuffle=True, seed=1, prefetch=0), ArrayLoader(x[:16], y[:16], 8, prefetch=0))
    cfg = _cfg(spec, n)
    res = fit(cfg, data, model=_preact(spec, torch.Generator().manual_seed(5)), max_steps=spec["steps"],
              device="cpu")
    out = state_arrays(res["state"])
    out["top1"] = np.array(res["best_top1"])
    if spec.get("restore"):
        from alignq_tpu_torch.dist import make_mesh
        from alignq_tpu_torch.dist.corr import create_local_duals
        from alignq_tpu_torch.train.checkpoint import CheckpointManager
        from alignq_tpu_torch.train.state import create_train_state

        model = _preact(spec, torch.Generator().manual_seed(11))
        fresh = create_train_state(torch.Generator().manual_seed(12), model, cfg, input_shape=(1, 8, 8, 3))
        mesh = make_mesh((n,), ("data",))
        fresh.admm_duals = create_local_duals(torch.Generator().manual_seed(13), sorted(fresh.admm_duals), cfg, n,
                                              mesh.rank, torch.float64)
        mgr = CheckpointManager(cfg.job_dir, mesh=mesh, local_duals=cfg.corr_mode == "local")
        restored, epoch = mgr.restore(fresh)
        out.update({f"r{k}": v for k, v in state_arrays(restored).items()})
        out["epoch"] = np.array(epoch)
    return out


def build_model_spec(m):
    """The float64 model a JSON model spec names: {'kind': 'preact',
    'bits', 'admm', 'method'} (a depth-8 PreActResNet) or {'kind':
    'densenet', 'bits', 'admm', 'stage_int8', 'calib'} (a depth-10
    DenseNet, deploy_exact on the int8 grid)."""
    gen = torch.Generator().manual_seed(5)
    if m["kind"] == "preact":
        return _preact(m, gen)
    from alignq_tpu_torch.models.densenet import DenseNet

    return DenseNet(depth=10, w_bit=m["bits"], a_bit=m["bits"], admm=m["admm"], variant="int8", deploy_exact=True,
                    stage_int8=m["stage_int8"], stage_calib=m["calib"], generator=gen).double()


def _worker_steps(rank, n, spec):
    """From a state given as arrays (spec['state']: p:, b:, and the duals
    a:, g: of gather mode, (B, B), and la:, lg: of local mode, (N, B/N,
    B/N)), one train step of each (corr_mode, grad_compression) case on
    this rank's rows of spec['batch']; returns each case's state and
    metrics, keyed 'mode/compression/'."""
    from alignq_tpu_torch.dist import make_mesh
    from alignq_tpu_torch.train.state import create_train_state
    from alignq_tpu_torch.train.steps import make_train_step

    arrays, batch = dict(np.load(spec["state"])), np.load(spec["batch"])
    x, y = batch["x"], batch["y"]
    b = len(y)
    rows = slice(rank * b // n, (rank + 1) * b // n)
    out = {}
    for mode, compression in spec["cases"]:
        local = mode == "local"
        model = build_model_spec(spec["model"])
        cfg = _cfg(spec["model"], n, train_batch_size=b, corr_mode=mode, grad_compression=compression, lr=spec["lr"],
                   correction_exclude=tuple(spec["correction_exclude"]), admm=False)
        state = create_train_state(torch.Generator().manual_seed(0), model, cfg, input_shape=(1,) + x.shape[1:],
                                   steps_per_epoch=10_000)
        given = {k: v for k, v in arrays.items() if k[:2] in ("p:", "b:")}
        for k, v in arrays.items():
            if k[:3] in ("la:", "lg:") and local:
                given[k[1:]] = v
            elif k[:2] in ("a:", "g:") and not local:
                given[k] = v
        load_state_arrays(state, given, rank if local else None)
        mesh = make_mesh((n,), ("data",)) if n > 1 else None
        step = make_train_step(model, _cfg(spec["model"], n, train_batch_size=b, corr_mode=mode, lr=spec["lr"],
                                           grad_compression=compression,
                                           correction_exclude=tuple(spec["correction_exclude"])), mesh)
        state, m = step(state, torch.from_numpy(x[rows]).double(), torch.from_numpy(y[rows]))
        tag = f"{mode}/{compression}/"
        out.update({tag + k: v for k, v in state_arrays(state).items()})
        out.update({tag + "m:" + k: v.detach().double().numpy() for k, v in m.items()})
    return out


def _worker_means(rank, n, spec):
    """compressed_tree_pmean of this rank's leaves (spec['inputs'], each
    leaf (N, ...) with this rank's at [rank]) in each mode, and the int8
    codes a rank sends (c:), from the scale every rank shares."""
    from alignq_tpu_torch.dist.collectives import compressed_pmean, compressed_tree_pmean

    leaves = np.load(spec["inputs"])
    tree = {k: torch.from_numpy(np.array(leaves[k][rank])) for k in leaves.files}
    out = {}
    for mode in ("f32", "bf16", "int8_gather"):
        out.update({f"{mode}/{k}": v.numpy() for k, v in compressed_tree_pmean(tree, None, mode).items()})
        out[f"{mode}/zero"] = compressed_pmean(tree["zero"], None, mode).numpy()  # one leaf alone
    for k, x in tree.items():
        amax = torch.tensor(float(np.abs(leaves[k]).max()), dtype=x.dtype)
        scale = torch.clamp_min(amax * (1.0 / 127.0), 1e-30)
        out[f"c:{k}"] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8).numpy()
    try:
        compressed_tree_pmean(tree, None, "int3")
    except ValueError:
        out["refused"] = np.array(1)
    return out


def _worker_da(rank, n, spec):
    """A gather-mode DA fit in float64: the digit DANN (28x28 synthetic
    mnist -> mnistm, batch 8; its channel dropout drawn for the global
    batch) or DSAN on a ResNet-18 trunk (32x32 synthetic Office-31 pair,
    batch 4, LMMD over both domains)."""
    from alignq_tpu_torch.train.da import DAConfig, fit_dann, fit_dsan

    bits, admm = spec["bits"], spec["admm"]
    gen = torch.Generator().manual_seed(7)
    q = dict(w_bit=bits, a_bit=bits, admm=admm, generator=gen)
    base = dict(bitW=bits, abitW=bits, admm=admm, num_epochs=1, job_dir=spec["job"], correction_exclude=(),
                mesh_shape=(n,), mesh_axes=("data",), seed=2)
    if spec["task"] == "digit":
        from alignq_tpu_torch.data.digits import get_digit_domain
        from alignq_tpu_torch.models import MNISTModelQuant

        loaders = {key: get_digit_domain(dom, spec["job"] + "/none", 8, train=train, seed=1)
                   for key, dom, train in (("src_train", "mnist", True), ("tgt_train", "mnistm", True),
                                           ("src_test", "mnist", False), ("tgt_test", "mnistm", False))}
        cfg = DAConfig(train_batch_size=8, eval_batch_size=8, num_classes=10, lr=0.01, use_correction=False, **base)
        res = fit_dann(cfg, loaders, MNISTModelQuant(**q).double(), max_steps=spec["steps"], device="cpu")
    else:
        from alignq_tpu_torch.data.office import get_office_pair
        from alignq_tpu_torch.models import DSAN

        loaders = get_office_pair(spec["job"] + "/none", "amazon", "webcam", 4, 32, seed=1, image_size=32)
        cfg = DAConfig(train_batch_size=4, eval_batch_size=32, num_classes=31, **base)
        res = fit_dsan(cfg, loaders, DSAN(arch="resnet18", num_classes=31, **q).double(), max_steps=spec["steps"],
                       device="cpu")
    out = state_arrays(res["state"])
    out["top1"] = np.array(res["best_tgt_top1"])
    return out


def _tp_restored(case, n, mesh_shape):
    """A fresh float64 state (another init) of a case's model on a mesh
    (placed as fit places it; (1, 1): one process) with the case's job's
    latest checkpoint restored into it."""
    from alignq_tpu_torch.train.checkpoint import CheckpointManager
    from alignq_tpu_torch.train.loop import _build_distributed
    from alignq_tpu_torch.train.state import create_train_state

    cfg = _cfg(case, n, job_dir=case["job"], mesh_shape=tuple(mesh_shape), mesh_axes=("data", "model"))
    model = _preact(case, torch.Generator().manual_seed(11))
    state = create_train_state(torch.Generator().manual_seed(12), model, cfg, input_shape=(1, 8, 8, 3))
    mesh = _build_distributed(cfg, model, state)[0] if np.prod(mesh_shape) > 1 else None
    state, epoch = CheckpointManager(cfg.job_dir, mesh=mesh).restore(state)
    return state


def _worker_tp_fit(rank, n, spec):
    """Each of spec['cases'] (a dict: tag, mesh (n_data, n_model), bits,
    admm, method, steps, job) a float64 fit of a depth-8 PreActResNet on
    8x8 images over that mesh of the n ranks ((1, 1): one process); keyed
    'tag/': the state's arrays (this rank's slices), 'w:' the whole
    network's parameters (whole_model), 'sharded' the sliced names. A
    case's 'restore' mesh: a fresh state on it restores the checkpoint of
    job 'restore_job' ('r:' keys, whole)."""
    from alignq_tpu_torch.data.loader import ArrayLoader, Data
    from alignq_tpu_torch.dist.sharding import param_shards, whole_model
    from alignq_tpu_torch.train.loop import fit

    out = {}
    for case in spec["cases"]:
        tag = case["tag"] + "/"
        if "steps" in case:
            x, y = tiny_images(32)
            data = Data(ArrayLoader(x, y, 8, shuffle=True, seed=1, prefetch=0),
                        ArrayLoader(x[:16], y[:16], 8, prefetch=0))
            cfg = _cfg(case, n, job_dir=case["job"], mesh_shape=tuple(case["mesh"]), mesh_axes=("data", "model"))
            res = fit(cfg, data, model=_preact(case, torch.Generator().manual_seed(5)), max_steps=case["steps"],
                      device="cpu")
            st = res["state"]
            out.update({tag + k: v for k, v in state_arrays(st).items()})
            out.update({tag + "w:" + k: v.detach().numpy() for k, v in whole_model(st.model).named_parameters()})
            out[tag + "sharded"] = np.array(sorted(param_shards(st.model)) or [""])
        if "restore" in case:
            restored = _tp_restored(dict(case, job=case["restore_job"]), n, case["restore"])
            out.update({tag + "r:" + k: v.detach().numpy()
                        for k, v in whole_model(restored.model).named_parameters()})
            out[tag + "r:step"] = np.array(restored.step)
    return out


def _worker_tp_units(rank, n, spec):
    """Over a (1, n) mesh: (q:) quantize_weight of each of spec['shapes']
    (HWIO; the port's OIHW) at W4 f64 on this rank's output-channel slice
    under model_shard; (g:) a column-parallel QConv for each method of
    spec['methods'] and a QDense, forward and backward on spec's fixed
    input and cotangent: the output, the input's gradient and each
    parameter's gradient (the kernel's this rank's slice); (m:) the
    multihost helpers on a (n, 1) mesh: place_batch_multihost and
    global_batch_from_local of a row-identifying batch."""
    from alignq_tpu_torch.dist import collectives as C
    from alignq_tpu_torch.dist import make_mesh, multihost
    from alignq_tpu_torch.dist.sharding import shard_model
    from alignq_tpu_torch.nn.layers import QConv, QDense
    from alignq_tpu_torch.quant.fake_quant import quantize_weight

    out = {}
    mesh = make_mesh((1, n), ("data", "model"))
    axis = mesh.model_axis()
    w_all = np.load(spec["weights"])
    for i, shape in enumerate(spec["shapes"]):
        w = torch.from_numpy(np.array(w_all[str(i)])).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        cw = w.shape[0] // n
        with C.model_shard(axis):
            out[f"q:{i}"] = quantize_weight(w[rank * cw:(rank + 1) * cw], 4).wq.numpy()
    for method in spec["methods"]:
        for kind in ("conv", "dense"):
            if kind == "dense" and method != "ours":
                continue
            gen = torch.Generator().manual_seed(3)
            layer = (QConv(8, 8, 3, padding=1, w_bit=4, a_bit=4, method=method, generator=gen) if kind == "conv"
                     else QDense(32, 8, w_bit=4, method="ours", generator=gen)).double()
            shard_model(layer, mesh)
            x = torch.from_numpy(np.array(w_all[f"x:{kind}"])).requires_grad_(True)
            y = layer(x)
            y.backward(torch.from_numpy(np.array(w_all[f"ct:{kind}"])))
            tag = f"g:{method}:{kind}:"
            out[tag + "y"] = y.detach().numpy()
            out[tag + "dx"] = x.grad.numpy()
            out.update({tag + k: p.grad.numpy() for k, p in layer.named_parameters()})
    dmesh = make_mesh((n, 1), ("data", "model"))
    batch = (np.arange(16, dtype=np.float32).reshape(16, 1) * 10.0, np.arange(16, dtype=np.int64))
    xs, ys = multihost.place_batch_multihost(batch, dmesh, "cpu")
    out["m:rows"] = ys.numpy()
    gx, gy = multihost.global_batch_from_local((xs, ys), dmesh)
    out["m:gx"], out["m:gy"] = gx.numpy(), gy.numpy()
    out["m:active"] = np.array(multihost.active())
    return out


def _worker_serve(rank, n, spec):
    """For each mesh shape of spec['meshes'] and each (artifact, engine
    batch) of spec['artifacts']: engine_from_artifact over that mesh on
    the CPU; rank 0 submits each of spec['requests'] (one engine batch of
    images each, one after another) and keeps the logits ('shape/i/j'),
    the other ranks serve until it closes. Each rank also keeps its mesh
    coordinates and its data and model groups' members ('shape/layout',
    'shape/groups')."""
    from alignq_tpu_torch.dist import make_mesh
    from alignq_tpu_torch.serve import engine_from_artifact

    reqs = np.load(spec["requests"])
    out = {}
    for shape in spec["meshes"]:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        groups = [torch.distributed.get_process_group_ranks(g) if g is not None else []
                  for g in (mesh.group, mesh.model_group)]
        out[f"{shape[0]}x{shape[1]}/layout"] = np.array([mesh.data_rank, mesh.model_rank])
        out[f"{shape[0]}x{shape[1]}/groups"] = np.array([r for g in groups for r in g])
        for i, (path, batch) in enumerate(spec["artifacts"]):
            engine = engine_from_artifact(path, batch, mesh=mesh, device="cpu")
            if rank == 0:
                for j in range(spec["n_requests"]):
                    out[f"{shape[0]}x{shape[1]}/{i}/{j}"] = engine.submit(reqs[f"{i}/{j}"]).result(timeout=300)
            engine.close()
    return out


WORKERS = {"fit": _worker_fit, "steps": _worker_steps, "means": _worker_means, "da": _worker_da,
           "tp_fit": _worker_tp_fit, "tp_units": _worker_tp_units, "serve": _worker_serve}


def dist_worker():
    """A rank of run_ranks: argv rank, n, port, spec path. Joins the gloo
    group (n > 1), runs the spec's kind, saves what it returns."""
    import json
    import sys

    rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(sys.argv[4]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    from alignq_tpu_torch.dist import multihost

    if n > 1:
        multihost.initialize(f"127.0.0.1:{port}", n, rank, device="cpu")
    out = WORKERS[spec["kind"]](rank, n, spec)
    if out:
        np.savez(spec["out"].format(rank=rank), **out)
    multihost.shutdown()
