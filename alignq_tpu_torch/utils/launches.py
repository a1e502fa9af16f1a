"""Launch records and bounds of the port's kernels on the card: the
yardstick that chip_smoke.py, the split scripts, the tools
(alignq_tpu_torch/tools/) and PERF.md's kernel table share.

- `card_line`: the card's name and power limit, as nvidia-smi gives them;
  printed beside every number kept.
- `bound`, `conv_bound`, `k3_bound`: a launch's least time on an H100 SXM,
  the larger of its bytes (each input read once, each output written once)
  over the memory rate and its operations over the peak rate of their type.
- `Site`: a conv kernel's call, as a recorded launch (`launch_site`) or a
  call of its entry point (`entry_site`) sees it; its key, and through
  `site_work` / `site_bound` its bytes and operations, the one count that
  `time_launch`, `profiling.cost_analysis` and `tools/shape_ceilings.py`
  share.
- `record_launches`, `launch_key`, `distinct_launches`: every launch of
  the kernels in a run, with its operands, and the distinct ones.
- `check_launch`: a recorded launch against its plain version.
- `time_launch`: a recorded launch's device time from a cold L2
  (utils/cuda_timing.py graph_ms), beside its plain version's, its bound
  and one PyTorch call of the same function where there is one.

Nothing here runs a kernel at import; the checks and times need a card.
"""

import contextlib
import subprocess
from typing import Callable, NamedTuple

from alignq_tpu_torch.utils.cuda_timing import graph_ms, median_ms, time_forward_ms

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# f32 operations of one K2 code (csrc/quantize.cu cdf_code: 2 multiplies,
# the divide, 6 multiply-adds at 2 each, 3 multiplies, the exp counted as 1,
# the sign, rint and 2 compares)
K2_OPS_PER_ELEMENT = 24
# ... of one code of K2's Hopper form (csrc/cdf_quant_sm90.cu: the bucket's
# multiply-add, its two clamps and conversion, the base's mask and offset,
# the step's compare and add, NaN's compare and select, the byte's packing)
K2_TABLE_OPS_PER_ELEMENT = 12
# f32 operations of one BN-act code on the CUDA cores (csrc/quantize.cu
# bn_act_code: the BN multiply-add at 2, then act_codes.cuh's map: erf 3
# multiplies, 2 clamps, 11 multiply-adds at 2, the divide, rint, 2 clamps,
# the relu; poly 2 clamps, 2 multiplies, 7 multiply-adds at 2, 2
# multiplies, rint, 2 clamps, the relu)
BN_ACT_OPS = {"erf": 34, "poly": 25}
# repetitions of a launch's timing: graph_ms runs of the launch, runs of
# its plain version (cut to keep chip_smoke.py within its call, CHANGES.md)
LAUNCH_RUNS, PLAIN_RUNS = 10, 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved, ops, peak_ops=PEAK_INT8_OPS_PER_S):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_work(b, h, w, cin, ksize, stride, n, out_bytes, pad=None, itemsize=1, depthwise=False, out_elems=None):
    """(bytes, operations) of a conv: its input read once (every pixel for
    a 3x3, 5x5 or 7x7, the strided sample for a 1x1) at itemsize bytes an
    element (an f32 image's 4), the weight and epilogue vectors, the (M, N)
    output, or out_elems where the kernel pools it, of out_bytes an
    element; 2*M*K*N operations (cin the input's channels as the conv's
    caller gives them: a stem's 3, which the wrapper's pad pass widens to
    the 4 K1 reads; a depthwise conv's K over one channel). pad: ksize // 2
    (a 'same' conv) where None; the digit convs' 0."""
    pad = ksize // 2 if pad is None else pad
    ho, wo = (h + 2 * pad - ksize) // stride + 1, (w + 2 * pad - ksize) // stride + 1
    m = b * ho * wo
    x_bytes = (b * h * w * cin if ksize > 1 else m * cin) * itemsize
    k = ksize * ksize * (1 if depthwise else cin)
    out = m * n if out_elems is None else out_elems
    return x_bytes + k * n + 8 * n + out_bytes * out, 2 * m * k * n


def conv_bound(b, h, w, cin, ksize, stride, n, out_bytes, pad=None, itemsize=1):
    """The conv's least time (ms, and what bounds it) from conv_work."""
    return bound(*conv_work(b, h, w, cin, ksize, stride, n, out_bytes, pad, itemsize))


def k3_work(pixels, c, n_blocks):
    """(bytes, operations) of K3 over a run of n_blocks on pixels NHWC
    pixels of C channels: the int16 stream read and written once and every
    conv's weight, scale and bias read once, against 2 convs a block of
    2*9*C*C int8 operations a pixel."""
    return 2 * 2 * c * pixels + n_blocks * 2 * (9 * c * c + 8 * c), n_blocks * 2 * 2 * pixels * 9 * c * c


def k3_bound(pixels, c, n_blocks):
    """K3's bound over a run (k3_work)."""
    return bound(*k3_work(pixels, c, n_blocks))


class Site(NamedTuple):
    """One conv kernel's call, however it was seen: a recorded launch
    (launch_site) or a call of its entry point (entry_site). It is the
    call's key (launch_key, shape_ceilings.conv_inventory), and site_work
    reads its bound's bytes and operations off it, so the kernel table,
    cost_analysis and the ceilings count a call alike."""

    kind: str  # K1, first, dw, stem or digit
    x: tuple  # the input's shape as the caller gives it (K1: before the pad pass)
    n: int  # channels out
    ksize: int
    stride: int
    pad: int
    mode: str  # the epilogue: the act map's impl, else the mode
    relu: object  # the act map's relu; None without a map
    itemsize: int  # bytes of an input element: an f32 image's 4 (first, stem, digit conv 1), codes' 1


def _site(kind, x, n, ksize, stride, pad, mode, act) -> Site:
    return Site(kind, tuple(x.shape), n, ksize, stride, pad, act.impl if act is not None else mode,
                act.relu if act is not None else None, x.element_size())


def site_work(site: Site) -> tuple:
    """(bytes, operations) of a conv kernel's call (conv_work): the stem's
    output its 3x3 stride-2 max pool (pad 1) in int16, the digit convs'
    their 2x2 pool; the depthwise conv's K over one channel."""
    b, h, w, c = site.x
    out_bytes, out_elems = _out_bytes(site.mode), None
    if site.kind in ("stem", "digit"):
        ho, wo = (h + 2 * site.pad - site.ksize) // site.stride + 1, (w + 2 * site.pad - site.ksize) // site.stride + 1
        hp, wp = ((ho + 1) // 2, (wo + 1) // 2) if site.kind == "stem" else (ho // 2, wo // 2)
        out_bytes, out_elems = (2 if site.kind == "stem" else 1), b * hp * wp * site.n
    return conv_work(b, h, w, c, site.ksize, site.stride, site.n, out_bytes, site.pad, site.itemsize,
                     site.kind == "dw", out_elems)


def site_bound(site: Site) -> tuple:
    """The call's least time (ms, and what bounds it): site_work over the
    int8 rate, the depthwise conv's over the f32 rate (its int32 sums run
    on the CUDA cores)."""
    return bound(*site_work(site), PEAK_F32_OPS_PER_S if site.kind == "dw" else PEAK_INT8_OPS_PER_S)


def bn_work(x, c_live, c_out, impl) -> tuple:
    """(bytes, operations) of a BN-act pass, either form: the live prefix
    of x read, the epilogue vectors, the codes written, BN_ACT_OPS an
    element."""
    m = x.numel() // x.shape[-1]
    return m * c_live * x.element_size() + 8 * c_live + m * c_out, BN_ACT_OPS.get(impl, 4) * m * c_live


def _out_bytes(mode) -> int:
    return 4 if mode in ("int32", "f32", "relu") else 1


def f32_mismatches(got, want) -> int:
    """Elements where got differs from want; raises if any is more than
    one ulp away."""
    import torch

    diff = got != want
    w = want[diff]
    near = (got[diff] == torch.nextafter(w, w + 1)) | (got[diff] == torch.nextafter(w, w - 1))
    if not bool(near.all()):
        raise AssertionError("an f32 result is more than one ulp from its plain version")
    return int(diff.sum())


def code_mismatches(got, want, what: str) -> int:
    """Codes where got differs from want; raises if any is more than one
    code away or more than 1e-6 of them differ."""
    diff = got != want
    n = int(diff.sum())
    if n and int((got[diff].int() - want[diff].int()).abs().max()) > 1:
        raise AssertionError(f"{what}: a code is more than one from its plain version")
    if n > 1e-6 * got.numel():
        raise AssertionError(f"{what}: {n} of {got.numel()} codes differ from the plain version")
    return n


def record_launches(fn):
    """Run fn with every K1, first-conv, stem, digit, depthwise and BN-act
    (both forms) launch recorded: a list of (kind, operands) in launch
    order; a K1 launch's operands end with the channels of the conv's input
    as its caller gave them; a first-conv launch's are (the f32 image, the
    packed weight, the plan, the mode, the map, the image's scale); a stem
    launch's are (the f32 image, the packed
    weight, the plan, 'codes', the map); a digit launch's (its conv's input
    as conv_pool takes it: conv 1's f32 image, the packed weight, the plan,
    the map); a table launch's (the buffer, c_live, the table, the Hopper
    kernel's plan or None, the map, c_out). The wrappers count as always."""
    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import quantize as K2
    from alignq_tpu_torch.kernels import stem as ST

    rec = []
    saved = (K1._k1_launch, DWm._dw_launch, K2._bn_act_launch, K2._bn_table_launch, K1._conv, ST._prep_launch,
             ST._stem_launch, DSm.digit_prep, DSm._digit_launch, FC._first_launch)
    conv_c = [None]  # the input channels of the conv in flight
    image = [None]  # the f32 image of the stem, or of the digit net's conv 1, in flight

    def conv(x, op, *a, **kw):
        conv_c[0] = x.shape[-1]
        try:
            return saved[4](x, op, *a, **kw)
        finally:
            conv_c[0] = None

    def k1(x, op, plan, out, mode, act=None):
        rec.append(("K1", (x, op, plan, mode, act, conv_c[0] or x.shape[-1])))
        saved[0](x, op, plan, out, mode, act)

    def dw(x, op, plan, impl, act, out):
        rec.append(("dw", (x, op, plan, impl, act)))
        saved[1](x, op, plan, impl, act, out)

    def bn(x, c_live, s, b, act, out):
        rec.append(("bn", (x, c_live, s, b, act, out.shape[-1])))
        saved[2](x, c_live, s, b, act, out)

    def bn_table(x, c_live, table, out, plan=None):
        rec.append(("bn_table", (x, c_live, table, plan, table.act, out.shape[-1])))
        saved[3](x, c_live, table, out, plan)

    def prep(x, q, *inv):
        image[0] = x
        saved[5](x, q, *inv)

    def stem(xq, op, act, plan, out):
        rec.append(("stem", (image[0], op, plan, "codes", act)))
        saved[6](xq, op, act, plan, out)

    def digit_prep(x):
        image[0] = x
        return saved[7](x)

    def digit(xin, op, act, plan, out):
        rec.append(("digit", (image[0] if plan.conv == 1 else xin, op, plan, act)))
        saved[8](xin, op, act, plan, out)

    def first(x, op, scale, act, mode, plan, out):
        rec.append(("first", (x, op, plan, mode, act, scale)))
        saved[9](x, op, scale, act, mode, plan, out)

    (K1._k1_launch, DWm._dw_launch, K2._bn_act_launch, K2._bn_table_launch, K1._conv, ST._prep_launch,
     ST._stem_launch, DSm.digit_prep, DSm._digit_launch, FC._first_launch) = (
        k1, dw, bn, bn_table, conv, prep, stem, digit_prep, digit, first)
    try:
        fn()
    finally:
        (K1._k1_launch, DWm._dw_launch, K2._bn_act_launch, K2._bn_table_launch, K1._conv, ST._prep_launch,
         ST._stem_launch, DSm.digit_prep, DSm._digit_launch, FC._first_launch) = saved
    return rec


def launch_site(kind, args) -> Site:
    """The Site of a recorded conv launch (record_launches' operands): a K1
    conv by its input as its caller gave it, the stem and digit conv 1 by
    their f32 images."""
    if kind == "K1":
        x, op, plan, mode, act, xc = args
        return Site("K1", (*x.shape[:-1], xc), op.n, plan.ksize, plan.stride, plan.pad,
                    act.impl if act is not None else mode, act.relu if act is not None else None, x.element_size())
    if kind == "first":
        x, op, _, mode, act, _ = args
        return _site(kind, x, op.n, 3, 1, 1, mode, act)
    if kind == "dw":
        x, _, plan, impl, act = args
        return _site(kind, x, x.shape[-1], 3, plan.stride, 1, impl, act)
    if kind == "stem":
        x, op, _, mode, act = args
        return _site(kind, x, op.n, 7, 2, 3, mode, act)
    if kind == "digit":
        x, op, _, act = args
        return _site(kind, x, op.n, 5, 1, 0, None, act)
    raise ValueError(f"{kind} runs no conv")


def launch_key(kind, args):
    """The distinct shape and epilogue of a recorded launch: a conv's Site
    (launch_site), a BN-act pass's buffer, live and output channels and
    map."""
    if kind in CONV_KINDS:
        return launch_site(kind, args)
    x, c_live, _, _, act, c_out = args
    return (kind, tuple(x.shape), str(x.dtype), c_live, c_out, act.impl, act.relu)


def distinct_launches(rec):
    """{launch_key: [operands, launches]} of a recorded run."""
    out = {}
    for kind, args in rec:
        key = launch_key(kind, args)
        if key in out:
            out[key][1] += 1
        else:
            out[key] = [(kind, args), 1]
    return out


def check_launch(kind, args):
    """The launch's wrapper against its plain version on the recorded
    operands: (differing elements, elements, max abs difference). int32
    and requant results must be identical; f32 within one ulp and codes
    within one code on at most 1e-6 of the elements (the plain version's
    float64 evaluation can round twice at an f32 midpoint). The first-conv
    kernel (against its chain under first_conv._old_form), the stem kernel,
    the digit kernel, the depthwise Hopper form and the table pass's Hopper
    kernel also against the forms they replaced (the stem's chain under
    stem._old_form, the digit conv's under digit._old_form, dwconv.cu under
    dwconv._old_form, quantize.cu's bn_table_kernel under
    quantize._old_form), bit for bit."""
    import torch

    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import quantize as K2

    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import first_conv as FC
    from alignq_tpu_torch.kernels import stem as ST

    key = launch_key(kind, args)
    if kind == "first":  # the kernel, bit for bit the chain it replaced, and its plain version
        x, op, _, mode, act, scale = args
        got, want = FC.first_conv(x, op, scale, act, mode), FC.first_conv_reference(x, op, scale, act, mode)
        with FC._old_form():
            old = FC.first_conv(x, op, scale, act, mode)
        if not torch.equal(got, old):
            raise AssertionError(f"{key}: the first-conv kernel differs from the chain it replaced in "
                                 f"{int((got != old).sum())} elements")
    elif kind == "K1":
        x, op, plan, mode, act, _ = args
        if act is not None:
            got, want = K1.int8_conv_codes(x, op, plan.stride, plan.pad, act), \
                K1.int8_conv_reference(x, op, plan.stride, plan.pad, act.impl, act)
        else:
            got, want = K1.int8_conv_packed(x, op, plan.stride, plan.pad, mode), \
                K1.int8_conv_reference(x, op, plan.stride, plan.pad, mode)
    elif kind == "dw":
        x, op, plan, impl, act = args
        got, want = DWm.dw_conv(x, op, plan.stride, impl, act), DWm.dw_conv_reference(x, op, plan.stride, impl, act)
        if isinstance(plan, DWm.DwSm90Plan):  # and bit for bit the form it replaced
            with DWm._old_form():
                old = DWm.dw_conv(x, op, plan.stride, impl, act)
            if not torch.equal(got.view(torch.int32) if got.dtype == torch.float32 else got,
                               old.view(torch.int32) if old.dtype == torch.float32 else old):
                raise AssertionError(f"{key}: the depthwise Hopper form differs from dwconv.cu's")
    elif kind == "stem":  # the kernel, bit for bit the chain it replaced, and its plain version
        x, op, plan, _, act = args
        got, want = ST.stem_pool_codes(x, op, act), ST.stem_reference(x, op, act)
        with ST._old_form():
            old = ST.stem_pool_codes(x, op, act)
        if not torch.equal(got, old):
            raise AssertionError(f"{key}: the stem kernel differs from the chain it replaced in "
                                 f"{int((got != old).sum())} codes")
    elif kind == "digit":  # the kernel, bit for bit the chain it replaced, and its plain version
        x, op, plan, act = args
        got, want = DSm.conv_pool(plan.conv, x, op, act), DSm.digit_reference(plan.conv, x, op, act)
        with DSm._old_form():
            old = DSm.conv_pool(plan.conv, x, op, act)
        if not torch.equal(got, old):
            raise AssertionError(f"{key}: the digit kernel differs from the chain it replaced in "
                                 f"{int((got != old).sum())} codes")
    elif kind == "bn":
        x, c_live, sv, bv, act, c_out = args
        got, want = K2.bn_act_codes(x, c_live, sv, bv, act, c_out), K2.bn_act_codes_plain(x, c_live, sv, bv, act, c_out)
    else:  # the table form, against the arithmetic's plain version on its table's (s, b, map) and the old kernel
        x, c_live, table, _, act, c_out = args
        got = K2.bn_act_codes_table(x, c_live, table, c_out)
        want = K2.bn_act_codes_plain(x, c_live, table.s, table.b, act, c_out)
        with K2._old_form():
            old = K2.bn_act_codes_table(x, c_live, table, c_out)
        hop = torch.empty_like(old)  # the Hopper kernel at the site, whichever form the rule gives it
        K2._bn_table_launch(x, c_live, table, hop,
                            K2.bn_table_plan(x.numel() // x.shape[-1], x.shape[-1], c_live, c_out,
                                             K2._sms(x.device.index or 0)))
        torch.cuda.synchronize()
        for form, codes in (("the rule's form", got), ("the Hopper kernel", hop)):
            if not torch.equal(codes, old):
                raise AssertionError(f"{key}: {form} differs from bn_table_kernel in "
                                     f"{int((codes != old).sum())} codes")
    torch.cuda.synchronize()
    if got.dtype == torch.float32:
        diff = f32_mismatches(got, want)
        if diff > 1e-6 * got.numel():
            raise AssertionError(f"{key}: {diff} f32 elements differ from the plain version")
    elif kind in ("K1", "first") and args[3] == "requant":
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(f"{key}: {diff} requant codes differ from the plain version")
    else:
        diff = code_mismatches(got, want, str(key))
    return diff, got.numel(), float((got.double() - want.double()).abs().max())


def time_launch(kind, args):
    """(ms, plain_ms, bound_ms, bound_by, library_ms, pad_ms) of one launch
    at its recorded operands (the stem kernel: its ms with its prep pass's,
    pad_ms that pass's, no library call computing the same function): the raw launch's device time from a cold L2
    (graph_ms), its plain version, its bound (a conv's site_bound: each
    input read once, each output written once, a K1 conv's input at the
    channels its caller gave, an f32 image at 4 bytes an element),
    one PyTorch call of the same product where there is one, also by
    graph_ms (K1: torch._int_mm on the gathered taps;
    depthwise: F.conv2d with groups=C on f32, TF32 off; the BN-act pass,
    either form: none), and the time of the wrapper's pad pass where a K1
    conv's caller gave fewer channels than K1 reads (else None). Both
    BN-act forms are read against the same bound: the live prefix read,
    the codes written, BN_ACT_OPS an element (bn_work). The digit kernel:
    its ms with conv 1's prep pass (pad_ms that pass's), no library call;
    its bound its input read (conv 1: the f32 image) and the pooled codes
    written, against its 2 * M * K * N int8 operations."""
    import torch

    from alignq_tpu_torch.kernels import digit as DSm
    from alignq_tpu_torch.kernels import dwconv as DWm
    from alignq_tpu_torch.kernels import qmatmul as K1
    from alignq_tpu_torch.kernels import quantize as K2

    from alignq_tpu_torch.kernels import stem as ST

    pad_ms = None
    if kind == "first":  # the bound: the f32 image read, the outputs written
        from alignq_tpu_torch.kernels import first_conv as FC

        x, op, plan, mode, act, scale = args
        dtype = torch.float32 if mode in ("f32", "relu") else torch.int32 if mode == "int32" else torch.int8
        out = torch.empty((x.numel() // 3, op.n), device=x.device, dtype=dtype)
        ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: FC._first_launch(x, op, scale, act, mode, plan, out))
        plain_ms = median_ms(lambda: FC.first_conv_reference(x, op, scale, act, mode), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = site_bound(launch_site(kind, args))
        cols = K1.gather_taps(K1._conv_input(FC.linear_q(x, scale), op), 3, 1, 1, K1.K_MULT)
        wmat = op.wt.t().contiguous()
        lib_ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: torch._int_mm(cols, wmat))
        return ms, plain_ms, b_ms, b_by, lib_ms, None
    if kind == "digit":
        x, op, plan, act = args
        c = DSm.CONVS[plan.conv]
        out = torch.empty((plan.B, c.pooled, c.pooled, c.n), device=x.device, dtype=torch.int8)
        xin = x
        if plan.conv == 1:
            xin = DSm.digit_prep(x)
            pad_ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: ST._prep_launch(x, xin, DSm._INV_S_DIGIT))
        ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: DSm._digit_launch(xin, op, act, plan, out)) + (pad_ms or 0.0)
        plain_ms = median_ms(lambda: DSm.digit_reference(plan.conv, x, op, act), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = site_bound(launch_site(kind, args))
        return ms, plain_ms, b_ms, b_by, None, pad_ms
    if kind == "stem":  # the kernel and its prep pass; the bound: the f32 image in, the pooled int16 out
        x, op, plan, _, act = args
        xq = ST.stem_prep(x)
        out = torch.empty((plan.B, plan.Hp, plan.Wp, ST.N_OUT), device=x.device, dtype=torch.int16)
        pad_ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: ST._prep_launch(x, xq))
        ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: ST._stem_launch(xq, op, act, plan, out)) + pad_ms
        plain_ms = median_ms(lambda: ST.stem_reference(x, op, act), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = site_bound(launch_site(kind, args))
        return ms, plain_ms, b_ms, b_by, None, pad_ms
    if kind == "K1":
        x, op, plan, mode, act, xc = args
        out_dtype = {"int32": torch.int32, "f32": torch.float32, "relu": torch.float32}.get(mode, torch.int8)
        out = torch.empty((plan.B * plan.Ho * plan.Wo, op.wt.shape[0]), device=x.device, dtype=out_dtype)
        ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: K1._k1_launch(x, op, plan, out, mode, act))
        impl = act.impl if act is not None else mode
        plain_ms = median_ms(lambda: K1.int8_conv_reference(x, op, plan.stride, plan.pad, impl, act), runs=PLAIN_RUNS,
                             warmup=0)
        b_ms, b_by = site_bound(launch_site(kind, args))
        if xc != x.shape[-1]:
            x_in = x[..., :xc].contiguous()  # the caller's input, before the pad pass
            pad_ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: K1._conv_input(x_in, op))
            del x_in
        cols = K1.gather_taps(x, plan.ksize, plan.stride, plan.pad, K1.K_MULT)
        wmat = op.wt.t().contiguous()
        lib_ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: torch._int_mm(cols, wmat))
        del cols
    elif kind == "dw":
        x, op, plan, impl, act = args
        b, h, w, c = x.shape
        stride = plan.stride
        dtype = {"int32": torch.int32, "f32": torch.float32}.get(impl, torch.int8)  # as dw_conv allocates
        out = torch.empty((b, plan.Ho, plan.Wo, c), device=x.device, dtype=dtype)
        ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: DWm._dw_launch(x, op, plan, impl, act, out))
        plain_ms = median_ms(lambda: DWm.dw_conv_reference(x, op, stride, impl, act), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = site_bound(launch_site(kind, args))
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = op.w.t().reshape(c, 1, 3, 3).float().contiguous()
        lib_ms = graph_ms(runs=LAUNCH_RUNS,
                          fn=lambda: torch.nn.functional.conv2d(xf, wf, stride=stride, padding=1, groups=c))
        del xf
    else:
        x, c_live, sv, bv, act, c_out = args
        out = torch.empty((*x.shape[:-1], c_out), device=x.device, dtype=torch.int8)
        if kind == "bn":
            ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: K2._bn_act_launch(x, c_live, sv, bv, act, out))
            plain_ms = median_ms(lambda: K2.bn_act_codes_plain(x, c_live, sv, bv, act, c_out), runs=PLAIN_RUNS,
                                 warmup=0)
        else:
            ms = graph_ms(runs=LAUNCH_RUNS, fn=lambda: K2._bn_table_launch(x, c_live, sv, out, bv))
            plain_ms = median_ms(lambda: K2.bn_act_codes_table_plain(x, c_live, sv, c_out), runs=PLAIN_RUNS, warmup=0)
        b_ms, b_by = bound(*bn_work(x, c_live, c_out, act.impl), PEAK_F32_OPS_PER_S)
        lib_ms = None
    return ms, plain_ms, b_ms, b_by, lib_ms, pad_ms


# The kernels' entry points, (kind, module, function): each runs its kernel
# on a CUDA tensor and its plain version on a CPU one, so what is recorded
# at them is the same on both devices (record_launches records the
# launches themselves, on the card only).
ENTRY_POINTS = (
    ("K1", "alignq_tpu_torch.kernels.qmatmul", "_conv"),
    ("gemm", "alignq_tpu_torch.kernels.qmatmul", "_gemm"),
    ("first", "alignq_tpu_torch.kernels.first_conv", "first_conv"),
    ("K3", "alignq_tpu_torch.kernels.stage_kernel", "stage_identity_blocks_nhwc"),
    ("dw", "alignq_tpu_torch.kernels.dwconv", "dw_conv"),
    ("stem", "alignq_tpu_torch.kernels.stem", "stem_pool_codes"),
    ("digit", "alignq_tpu_torch.kernels.digit", "conv_pool"),
    ("bn", "alignq_tpu_torch.kernels.quantize", "bn_act_codes"),
    ("bn_table", "alignq_tpu_torch.kernels.quantize", "bn_act_codes_table"),
    ("K2", "alignq_tpu_torch.kernels.quantize", "cdf_quantize_int8"),
)
CONV_KINDS = ("K1", "first", "dw", "stem", "digit")  # the entry points that run a conv


class EntryCall(NamedTuple):
    """One call of a kernel's entry point: run it by fn(**args)."""

    kind: str
    fn: Callable
    args: dict  # the call's arguments by name, defaults applied


@contextlib.contextmanager
def at_entry_points(hook):
    """While open, each outermost call of a kernel's entry point
    (ENTRY_POINTS) returns hook(EntryCall); a call made inside another (a
    chain's K1 conv, a plain version's) runs as it is. Each entry point is
    patched in its module and wherever the package imported it by name."""
    import importlib
    import inspect
    import sys

    depth = [0]
    patched = []

    def wrap(kind, fn):
        sig = inspect.signature(fn)

        def entry(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            depth[0] += 1
            try:
                return hook(EntryCall(kind, fn, dict(args.arguments)))
            finally:
                depth[0] -= 1

        return entry

    for kind, module, name in ENTRY_POINTS:
        fn = getattr(importlib.import_module(module), name)
        entry = wrap(kind, fn)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("alignq_tpu_torch") and getattr(mod, name, None) is fn:
                patched.append((mod, name, fn))
                setattr(mod, name, entry)
    try:
        yield
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def entry_mode(a: dict) -> str:
    """The epilogue mode of an entry point's call: its act map's, or its mode."""
    act = a.get("act")
    return act.impl if act is not None else a["mode"]


def entry_site(call: EntryCall) -> Site:
    """The Site of a conv entry point's call (launch_site's, from the
    entry point's arguments)."""
    a, kind = call.args, call.kind
    x, act = a["x"], a.get("act")
    if kind == "K1":
        return _site(kind, x, a["op"].n, a["op"].ksize, a["stride"], a["padding"], a["mode"], act)
    if kind == "first":
        return _site(kind, x, a["op"].n, 3, 1, 1, a["mode"], act)
    if kind == "dw":
        return _site(kind, x, x.shape[-1], 3, a["stride"], 1, a["mode"], act)
    if kind == "stem":
        return _site(kind, x, a["op"].n, 7, 2, 3, "codes", act)
    if kind == "digit":
        return _site(kind, x, a["op"].n, 5, 1, 0, None, act)
    raise ValueError(f"{kind} runs no conv")


def conv_row(site: Site) -> tuple:
    """(cin, cout, hw, ksize, stride) of a conv's Site: cin its input's
    channels as the caller gives them, hw the input's side."""
    return site.x[-1], site.n, site.x[1], site.ksize, site.stride


def entry_work(call: EntryCall) -> tuple:
    """(bytes, operations) of an entry point's call by the kernel's own
    formula, whichever device runs it, as time_launch bounds its launch:
    a conv's site_work, K3's k3_work, the BN-act passes' bn_work, a GEMM's
    operands and 2*M*K*N, K2's bytes and K2_OPS_PER_ELEMENT an element."""
    a, kind = call.args, call.kind
    x = a["x"]
    if kind in CONV_KINDS:
        return site_work(entry_site(call))
    if kind == "gemm":
        (m, k), n = x.shape, a["op"].n
        return m * k + k * n + 8 * n + _out_bytes(entry_mode(a)) * m * n, 2 * m * k * n
    if kind == "K3":
        b, h, w, c = x.shape
        return k3_work(b * h * w, c, len(a["ms"]))
    if kind in ("bn", "bn_table"):
        c_out = a["c_out"] if a["c_out"] is not None else a["c_live"]
        return bn_work(x, a["c_live"], c_out, (a["act"] if kind == "bn" else a["table"].act).impl)
    if kind == "K2":
        return 5 * x.numel(), K2_OPS_PER_ELEMENT * x.numel()
    raise ValueError(f"no formula for {kind}")


def device_line(dev) -> str:
    """card_line() on a CUDA device; on the CPU, a line that says so: the
    first line a tool prints."""
    return card_line() if dev.type == "cuda" else "cpu (no card)"


def device_ms(fn, dev, runs: int = LAUNCH_RUNS) -> float:
    """The time of one call of fn, a function that only launches work:
    graph_ms on the card (device time from a cold L2); on the CPU the
    median of `runs` calls on the host clock (no device metric)."""
    if dev.type == "cuda":
        return graph_ms(fn, runs=runs)
    return time_forward_ms(fn, dev, runs, warmup=1)
