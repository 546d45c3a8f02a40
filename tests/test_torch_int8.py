"""The port's int8 serving mode (clip_codec_tpu_torch/ops/int8.py and the
models' int8 forms) against the JAX package's (clip_codec_tpu/ops/int8.py).

On the CPU the kernels run their plain versions: the codes in fp32, the
integer product exactly in float64. Tiny configs, the same numpy inputs and
converted parameters through both packages:

* weight codes and scales, and activation codes (exact ties included),
  bit-equal to JAX's;
* the act form (the conv that quantizes its own activations: one launch on
  the card) bit-equal to the two-step plain form and within one ulp of
  JAX's layers, bf16 and fp32 inputs, dynamic and static; the model paths
  run the two-launch form, bit-equal to the act form;
* single layers (3x3 stride 1 and 2, 1x1, and the Linear) against
  ``dynamic_int8_conv``, ``static_int8_conv`` and ``Int8Dense``, fp32,
  within one ulp of max|y|;
* whole U-Nets, the pixel ``CLIPCondUNet`` (base 8, ch_mult (1, 2), 16px)
  and the SD ``SDUNet`` (tests/test_torch_sd.py's config, 16x16 latents),
  dynamic and static, fp32 and bf16. int8 is discontinuous: two fp32
  implementations that differ by one rounding in a layer's input flip a
  code where ``x / s`` lies within that rounding of a half, and from there
  the two networks part by about the quantization error itself. So the
  U-Net is run teacher-forced: every int8 layer the port calls, in order,
  gets JAX's input for that layer and must give JAX's output within one
  ulp of its largest magnitude (the codes, the scale, the product, the
  epilogue), the port's own input to it must lie within ||delta|| / ||ref||
  <= 1e-5 (fp32) or 3e-2 (bf16: the fp ops between two int8 layers round
  to bf16 at other places in the two packages, and GroupNorm over the 32
  values of a group at 4x4 amplifies that) of JAX's, and the layer hands
  JAX's output on. The U-Net's output then agrees with JAX's within
  ||delta|| / ||ref|| <= 1e-4 in fp32 and 2e-2 in bf16;
* calibration against ``calibrate_unet`` and the SD decoder's
  ``calibrate_int8_scales`` (JAX's latents injected) within 1e-6 relative,
  but for the cross-attention's to_k and to_v, whose absmax is max|context|
  of the adapter's output (2e-6: see the test);
* the switch semantics JAX's tests/test_int8.py pins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import clip_codec_tpu.ops.int8 as ji
from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.weights.convert_sd import convert_sd_adapter, convert_sd_unet, convert_sd_vae
from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.models.blocks import ResBlock
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.ops import groupnorm as gn
from clip_codec_tpu_torch.ops import int8 as q8
from clip_codec_tpu_torch.weights.from_jax import sd_unet_quant_from_jax, unet_quant_from_jax, unet_state_dict_from_jax
from tests.test_torch_deploy import jax_unet_params

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))
UCFG = dict(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)
VCFG = dict(block_out=(8, 16), layers_per_block=1, latent_ch=4)
CLIP_DIM = 8
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def int8_off():
    """Both packages' process switches off after every test (workers share
    processes across test files)."""
    try:
        yield
    finally:
        ji.set_int8_conv(False)
        q8.set_int8_conv(False)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if torch.is_tensor(x) else np.asarray(x, np.float32), np.float32)


def _ulp(a: np.ndarray, dtype) -> float:
    """One unit in the last place of max|a| in ``dtype`` (fp32 or bf16)."""
    m = float(np.abs(a).max())
    if dtype in (torch.float32, jnp.float32):
        return float(np.spacing(np.float32(m)))
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------------ codes and layers


def _jax_weight_codes(kernel):
    """JAX's ops/int8.py:63-65 on a kernel whose last axis is the output."""
    axes = tuple(range(kernel.ndim - 1))
    w_scale = jnp.maximum(jnp.max(jnp.abs(kernel), axis=axes) / 127.0, 1e-12)
    return np.asarray(jnp.clip(jnp.round(kernel / w_scale), -127, 127).astype(jnp.int8)), np.asarray(w_scale)


@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1", "dense"])
def test_weight_codes_bit_equal_to_jax(rng, kind):
    shape = {"conv3x3": (3, 3, 16, 96), "conv1x1": (1, 1, 16, 96), "dense": (16, 512)}[kind]
    k = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    k[..., 5] = 0.05  # ties: every weight of a channel at its own max
    wq_j, ws_j = _jax_weight_codes(jnp.asarray(k))
    w = torch.from_numpy(k).permute(3, 2, 0, 1) if k.ndim == 4 else torch.from_numpy(k).T
    wq, ws = q8.quantize_weight(w.contiguous())
    assert wq.dtype == torch.int8 and wq.shape == (shape[-1], *(k.shape[:2] if k.ndim == 4 else (1, 1)), 16)
    np.testing.assert_array_equal(ws.numpy(), ws_j)
    want = wq_j.transpose(3, 0, 1, 2) if k.ndim == 4 else wq_j.T[:, None, None, :]
    np.testing.assert_array_equal(wq.numpy(), want)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_activation_codes_bit_equal_to_jax(rng, mode, dtype):
    """Codes of random values and of exact ties (k + 1/2) * s, saturating
    values past the scale, and the scale itself."""
    jd, td = DTYPES[dtype]
    absmax = np.float32(127 / 64)  # s = 1/64: every half below 128 s is a bf16 value too
    s = np.float32(absmax / np.float32(127.0))
    ties = (np.arange(-140, 140, dtype=np.float32) + np.float32(0.5)) * s
    x = np.concatenate([rng.standard_normal(4000).astype(np.float32), ties, [3.0, -3.0, 0.0]])
    x = np.asarray(jnp.asarray(x, jd).astype(jnp.float32))  # representable in the working dtype
    x32 = jnp.asarray(x)
    am = jnp.max(jnp.abs(x32)) if mode == "dynamic" else jnp.asarray(absmax)
    sj = jnp.maximum(am, 1e-12) / 127.0
    want = np.asarray(jnp.clip(jnp.round(x32 / sj), -127, 127).astype(jnp.int8))
    xt = torch.from_numpy(x.copy()).to(td)
    xq, st = q8.quantize_act(xt, None if mode == "dynamic" else torch.tensor(absmax))
    np.testing.assert_array_equal(xq.numpy(), want)
    assert st.item() == float(sj)
    if mode == "static":  # many x / s are exact halves, and go to the even code
        q = np.asarray(x32[4000:4280] / sj)
        exact = (q - np.floor(q) == 0.5) & (np.abs(q) < 127)
        assert exact.sum() >= 100 and (want[4000:4280][exact] % 2 == 0).all()


def _max_ulp(got, want, dtype) -> float:
    return float(np.abs(_np(got) - _np(want)).max()) / _ulp(_np(want), dtype)


CONVS = {"3x3 s1 p1": (3, 1, 1), "3x3 s2 p1": (3, 2, 1), "1x1": (1, 1, 0)}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_int8_conv2d_matches_jax_within_one_ulp(rng, conv, mode):
    k, stride, pad = CONVS[conv]
    x = rng.standard_normal((2, 9, 10, 32)).astype(np.float32)
    w = (rng.standard_normal((k, k, 32, 16)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    absmax = np.float32(3.0)  # a calibrated value below max|x|: codes saturate
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    pads = ((pad, pad), (pad, pad))
    want = (ji.dynamic_int8_conv(*args, (stride, stride), pads) if mode == "dynamic"
            else ji.static_int8_conv(*args, jnp.asarray(absmax), (stride, stride), pads))
    wq, ws = q8.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous())
    xq, s = q8.quantize_act(torch.from_numpy(x), None if mode == "dynamic" else torch.tensor(absmax))
    got = q8.int8_conv2d(xq, wq, ws, s, torch.from_numpy(b), stride, pad, torch.float32)
    assert got.shape == want.shape
    assert _max_ulp(got, want, torch.float32) <= 1.0
    acc = q8.int8_conv2d(xq, wq, ws, s, None, stride, pad, torch.int32)
    assert acc.dtype == torch.int32 and torch.equal(acc, q8.int8_conv2d_plain(xq, wq, ws, s, None, stride, pad,
                                                                                torch.int32))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_linear_matches_int8_dense(rng, mode):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    mod = ji.Int8Dense(24)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"], "bias": jnp.asarray(rng.standard_normal(24) * 0.1, jnp.float32)}
    variables = {"params": params}
    if mode == "static":
        variables["quant"] = {"x_absmax": jnp.float32(2.0)}
    want = mod.apply(variables, jnp.asarray(x))
    layer = torch.nn.Linear(48, 24)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).T))
        layer.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    if mode == "static":
        layer.__dict__["_x_absmax"] = torch.tensor(2.0)
    got = q8.linear(layer, torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 5, 24) and _max_ulp(got, want, torch.float32) <= 1.0


# (x shape, kernel size or None for Int8Dense, stride, padding): the act form's plan forms
ACT_CASES = {
    "3x3 s1 bf16 dynamic": ((2, 9, 10, 32), 3, 1, 1, "bf16", "dynamic"),
    "3x3 s1 fp32 static half": ((2, 9, 10, 32), 3, 1, 1, "fp32", "static"),
    "3x3 s2 bf16 static half": ((2, 9, 10, 32), 3, 2, 1, "bf16", "static"),
    "3x3 s2 fp32 dynamic": ((2, 9, 10, 32), 3, 2, 1, "fp32", "dynamic"),
    "1x1 gemm fp32 dynamic": ((2, 9, 10, 64), 1, 1, 0, "fp32", "dynamic"),
    "1x1 gemm bf16 static half": ((2, 9, 10, 64), 1, 1, 0, "bf16", "static"),
    "swapped M=30 3x3 bf16 dynamic": ((1, 5, 6, 32), 3, 1, 1, "bf16", "dynamic"),
    "dense M=16 fp32 static half": ((2, 8, 48), None, 1, 0, "fp32", "static"),
    "dense M=16 bf16 dynamic": ((2, 8, 48), None, 1, 0, "bf16", "dynamic"),
}


@pytest.mark.parametrize("case", list(ACT_CASES))
def test_int8_conv_act_equals_the_two_step_form_and_jax(rng, case):
    """``int8_conv2d_act`` / ``int8_linear_act`` (on the card one launch that
    quantizes in shared memory) against ``quantize_plain`` then
    ``int8_conv2d_plain`` bit for bit, and against JAX's
    ``dynamic_int8_conv`` / ``static_int8_conv`` / ``Int8Dense`` on the same
    numpy inputs within one ulp of max|y| (fp32 out). Static runs at half
    the dynamic absmax, so codes saturate."""
    xs, k, stride, pad, dt, mode = ACT_CASES[case]
    jd, td = DTYPES[dt]
    x = np.asarray(jnp.asarray(rng.standard_normal(xs).astype(np.float32), jd).astype(jnp.float32))
    cin, cout = xs[-1], 24
    absmax = np.float32(np.abs(x).max() * 0.5)
    xt = torch.from_numpy(x).to(td)
    am = q8.absmax(xt) if mode == "dynamic" else torch.tensor(absmax)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    if k is None:  # a Linear over the last axis: Int8Dense
        mod = ji.Int8Dense(cout)  # fp32 out; the input is bf16 where dt is
        kernel = (rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)
        variables = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(b)}}
        if mode == "static":
            variables["quant"] = {"x_absmax": jnp.float32(absmax)}
        want = np.asarray(mod.apply(variables, jnp.asarray(x, jd)).astype(jnp.float32))
        wq, ws = q8.quantize_weight(torch.from_numpy(kernel).T.contiguous())
        got = q8.int8_linear_act(xt, am, wq, ws, torch.from_numpy(b), torch.float32)
        xq, s = q8.quantize_plain(xt.reshape(-1, 1, 1, cin), am)
        two = q8.int8_conv2d_plain(xq, wq, ws, s, torch.from_numpy(b), 1, 0, torch.float32).reshape(got.shape)
    else:
        w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
        args = (jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b))
        pads = ((pad, pad), (pad, pad))
        want = (ji.dynamic_int8_conv(*args, (stride, stride), pads) if mode == "dynamic"
                else ji.static_int8_conv(*args, jnp.asarray(absmax), (stride, stride), pads))
        wq, ws = q8.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous())
        got = q8.int8_conv2d_act(xt, am, wq, ws, torch.from_numpy(b), stride, pad, torch.float32)
        xq, s = q8.quantize_plain(xt, am)
        two = q8.int8_conv2d_plain(xq, wq, ws, s, torch.from_numpy(b), stride, pad, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, two)
    assert _max_ulp(got, want, torch.float32) <= 1.0
    acc = q8.int8_conv2d_act(xt.reshape(-1, 1, 1, cin) if k is None else xt, am, wq, ws, None,
                             1 if k is None else stride, 0 if k is None else pad, torch.int32)
    assert acc.dtype == torch.int32 and bool((acc.abs() <= 127 * 127 * wq[0].numel()).all())


def test_model_paths_run_the_pair_and_equal_the_act_form(pixel, sd, monkeypatch):
    """The pixel and SD U-Nets' int8 forwards, dynamic and static, run
    ``int8_conv2d`` once a layer on codes from ``quantize`` or, for the
    pixel ResBlocks' convs in static mode, from ``group_norm_silu_int8``
    (K1's codes-out form), and never the act form, which is slower on the
    card at every path shape; the same forwards with every layer's ``conv``
    and ``linear`` through the act form are bit for bit the same."""
    real = {name: getattr(q8, name) for name in ("quantize", "int8_conv2d", "int8_conv2d_act")}
    real_gn = gn.group_norm_silu_int8
    calls = []

    def counted(name):
        return lambda *a, **kw: calls.append(name) or real[name](*a, **kw)

    def act_conv(layer, x, dtype, stride=1, padding=1):
        wq, ws = q8.layer_weight(layer)
        am = layer.__dict__.get("_x_absmax")
        return real["int8_conv2d_act"](x, q8.absmax(x) if am is None else am, wq, ws, q8._bias(layer), stride,
                                       padding, dtype)

    def act_linear(layer, x, dtype):
        wq, ws = q8.layer_weight(layer)
        am = layer.__dict__.get("_x_absmax")
        return q8.int8_linear_act(x, q8.absmax(x) if am is None else am, wq, ws, q8._bias(layer), dtype)

    for name in ("quantize", "int8_conv2d", "int8_conv2d_act"):
        monkeypatch.setattr(q8, name, counted(name))
    monkeypatch.setattr(gn, "group_norm_silu_int8",
                        lambda *a, **kw: calls.append("group_norm_silu_int8") or real_gn(*a, **kw))
    net = _pixel_port(pixel, torch.float32, int8=True)
    unet = tsd.SDUNet(tsd.SDUNetConfig(**UCFG), dtype=torch.bfloat16, int8=True)
    unet.load_state_dict(sd["sd"][0], strict=True)
    runs = [(net, [torch.from_numpy(a) for a in pixel["inputs"]],
             unet_quant_from_jax(pixel["jquant"], CFG["ch_mult"])),
            (unet.eval(), [torch.from_numpy(a) for a in sd["inputs"]], sd_unet_quant_from_jax(sd["jquant"]))]
    with torch.no_grad():
        for model, args, quant in runs:
            for q in (None, quant):
                q8.load_quant(model, q)
                calls.clear()
                out = model(*args)
                layers = len(q8.int8_layer_names(model))
                resblock_convs = 2 * sum(isinstance(m, ResBlock) for m in model.modules())
                assert (resblock_convs > 0) == (model is net)
                fused = 0 if q is None else resblock_convs
                assert calls.count("int8_conv2d") == layers and calls.count("group_norm_silu_int8") == fused
                assert calls.count("quantize") == layers - fused and len(calls) == 2 * layers
                with monkeypatch.context() as m:
                    m.setattr(q8, "conv", act_conv)
                    m.setattr(q8, "linear", act_linear)
                    m.setattr(q8, "static_absmax", lambda layer: None)  # every layer through conv/linear
                    act = model(*args)
                assert bool(torch.isfinite(out.float()).all()) and torch.equal(out, act)


# ------------------------------------------------------------------ teacher-forced U-Nets


def _jax_trace(apply, variables, *args):
    """JAX's output and, in call order, every int8 layer's (path, input,
    output). Eager, op by op, as JAX's own tests run it: under jit XLA fuses
    the epilogue's multiply and add and moves results by ulps."""
    calls = []

    def record(next_fun, a, kw, ctx):
        y = next_fun(*a, **kw)
        if ctx.method_name == "__call__" and isinstance(ctx.module, (ji.Int8Conv, ji.Int8Dense)):
            calls.append((ctx.module.path, _np(a[0]), _np(y)))
        return y

    with nn.intercept_methods(record):
        out = apply(variables, *args)
    return _np(out), calls


def _by_port_name(calls, to_port):
    """JAX's calls keyed by the port's layer names: the quant converter maps
    a tree of call ids; GEGLU's proj_h and proj_g (one input, one id)
    become the port's one projection, their outputs side by side."""
    tree, ids = {}, {}
    for path, _, _ in calls:
        geglu = path[-1] in ("proj_h", "proj_g")
        key = path[:-1] + ("proj_h",) if geglu else path
        ids.setdefault(key, float(len(ids) + 1))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {"x_absmax": ids[key]}
    name_of = {float(v): k for k, v in to_port(tree).items()}
    out = {}
    for path, x, y in calls:
        geglu = path[-1] in ("proj_h", "proj_g")
        name = name_of[ids[path[:-1] + ("proj_h",) if geglu else path]]
        if geglu and path[-1] == "proj_g":
            jx, jy = out[name][-1]
            out[name][-1] = (jx, np.concatenate([jy, y], axis=-1))
        else:
            out.setdefault(name, []).append((x, y))
    return out


class _Forced:
    """The port's int8 layers teacher-forced by JAX's calls: each checks
    its own input and its output on JAX's input, then hands on JAX's output."""

    def __init__(self, model, jcalls, dtype, monkeypatch):
        self.names = {id(m): n for n, m in model.named_modules()}
        self.jcalls, self.dtype = jcalls, dtype
        self.glue, self.out_ulps = [], []
        # Every layer through ``conv``/``linear``, whose input JAX's is: the
        # static pixel ResBlocks' codes-out form (K1 writing the codes) is
        # bit-equal to that two-step form (tests/test_torch_gn_int8.py).
        monkeypatch.setattr(q8, "static_absmax", lambda layer: None)
        monkeypatch.setattr(q8, "conv", self.wrap(q8.conv))
        monkeypatch.setattr(q8, "linear", self.wrap(q8.linear))

    def wrap(self, real):
        def forced(layer, x, dtype, *a, **kw):
            jx, jy = self.jcalls[self.names[id(layer)]].pop(0)
            assert x.shape == jx.shape
            self.glue.append(_rel(x, jx))
            y = real(layer, torch.from_numpy(jx).to(x.dtype), dtype, *a, **kw)
            assert y.dtype == dtype and y.shape == jy.shape
            self.out_ulps.append(_max_ulp(y, jy, dtype))
            return torch.from_numpy(jy).to(dtype)
        return forced

    def check(self, n_layers):
        assert all(not v for v in self.jcalls.values()), "JAX ran int8 layers the port did not"
        assert len(self.out_ulps) == n_layers
        assert max(self.out_ulps) <= 1.0, self.out_ulps
        assert max(self.glue) <= (1e-5 if self.dtype == torch.float32 else 3e-2), self.glue


def _quant_tree(calls):
    """A JAX quant collection from a trace: each int8 layer's max|x| (one
    batch's calibration, taken from the int8 forward itself)."""
    tree = {}
    for path, x, _ in calls:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {"x_absmax": jnp.float32(np.abs(x).max())}
    return tree


def _assert_forced_forward(monkeypatch, port_model, port_args, trace, to_port, dtype):
    jout, calls = trace
    forced = _Forced(port_model, _by_port_name(calls, to_port), dtype, monkeypatch)
    with torch.no_grad():
        out = port_model(*port_args)
    forced.check(len(calls) - sum(p[-1] == "proj_g" for p, _, _ in calls))
    assert _rel(out, jout) <= (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.fixture(scope="module")
def pixel():
    params = jax_unet_params(CFG, 3)
    rng = np.random.default_rng(7)
    inputs = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32),
              rng.standard_normal((2, 8)).astype(np.float32), np.array([3, 40], np.int32))
    trace = _jax_trace(JaxUNet(**CFG, fused_pallas=False, int8=True).apply, {"params": params}, *inputs)
    return dict(params=params, sd=unet_state_dict_from_jax(params, CFG["ch_mult"]), inputs=inputs,
                trace=trace, jquant=_quant_tree(trace[1]))


def _pixel_port(pixel, dtype, **kw):
    net = CLIPCondUNet(**CFG, time_dim=256, dtype=dtype, **kw)
    net.load_state_dict(pixel["sd"], strict=True)
    return net.eval()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pixel_unet_matches_jax(pixel, monkeypatch, mode, dtype):
    jd, td = DTYPES[dtype]
    net = _pixel_port(pixel, td, int8=True)
    variables = {"params": pixel["params"]}
    if mode == "static":
        variables["quant"] = pixel["jquant"]
        q8.load_quant(net, unet_quant_from_jax(pixel["jquant"], CFG["ch_mult"]))
    jnet = JaxUNet(**CFG, fused_pallas=False, int8=True, dtype=jd)
    trace = pixel["trace"] if (mode, dtype) == ("dynamic", "fp32") else _jax_trace(jnet.apply, variables,
                                                                                   *pixel["inputs"])
    _assert_forced_forward(monkeypatch, net, [torch.from_numpy(a) for a in pixel["inputs"]], trace,
                           lambda t: unet_quant_from_jax(t, CFG["ch_mult"]), td)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    init_params(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module.eval()


@pytest.fixture(scope="module")
def sd():
    unet = _seeded(tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), 10)
    vae = _seeded(tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)), 11)
    adapter = _seeded(tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2), 12)
    sds = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in (unet, vae, adapter)]
    jp = (convert_sd_unet(sds[0], n_blocks=2, layers_per_block=1), convert_sd_vae(sds[1], n_blocks=2, enc_layers=1),
          convert_sd_adapter({"adapter": sds[2]}))
    rng = np.random.default_rng(8)
    inputs = (rng.standard_normal((2, 16, 16, 4)).astype(np.float32), np.array([981, 41], np.int32),
              rng.standard_normal((2, 2, 16)).astype(np.float32))
    trace = _jax_trace(jsd.SDUNet(jsd.SDUNetConfig(**UCFG), int8=True).apply, {"params": jp[0]}, *inputs)
    return dict(sd=sds, jax=jp, inputs=inputs, trace=trace, jquant=_quant_tree(trace[1]))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sd_unet_matches_jax(sd, monkeypatch, mode, dtype):
    jd, td = DTYPES[dtype]
    unet = tsd.SDUNet(tsd.SDUNetConfig(**UCFG), dtype=td, int8=True)
    unet.load_state_dict(sd["sd"][0], strict=True)
    variables = {"params": sd["jax"][0]}
    if mode == "static":
        variables["quant"] = sd["jquant"]
        q8.load_quant(unet.eval(), sd_unet_quant_from_jax(sd["jquant"]))
    jnet = jsd.SDUNet(jsd.SDUNetConfig(**UCFG), dtype=jd, int8=True)
    trace = sd["trace"] if (mode, dtype) == ("dynamic", "fp32") else _jax_trace(jnet.apply, variables, *sd["inputs"])
    _assert_forced_forward(monkeypatch, unet.eval(), [torch.from_numpy(a) for a in sd["inputs"]], trace,
                           sd_unet_quant_from_jax, td)


# ------------------------------------------------------------------ calibration


def test_calibrate_unet_matches_jax(pixel):
    jnet = JaxUNet(**CFG, fused_pallas=False, int8=True)
    want = unet_quant_from_jax(ji.calibrate_unet(jnet.apply, {"params": pixel["params"]}, 16, 8, timesteps=50,
                                                 batch=2), CFG["ch_mult"])
    net = _pixel_port(pixel, torch.float32, int8=True)
    got = q8.calibrate_unet(net, 16, 8, timesteps=50, batch=2)
    assert set(got) == set(want) == set(q8.int8_layer_names(net)) and len(got) == 22
    for k in want:
        assert got[k].shape == () and got[k].dtype == torch.float32
        assert abs(got[k].item() - want[k].item()) <= 1e-6 * want[k].item(), k


def test_calibrate_int8_scales_matches_jax(sd):
    """Both CFG branches at the three schedule points, JAX's latents
    injected (the port draws its own from a torch generator otherwise)."""
    jdec = jsd.StableDiffusionDecoder(sd["jax"][1], sd["jax"][0], adapter_params=sd["jax"][2], clip_dim=CLIP_DIM,
                                      n_tokens=2, unet_cfg=jsd.SDUNetConfig(**UCFG), vae_cfg=jsd.VAEConfig(**VCFG),
                                      dtype=jnp.float32, int8=True)
    z = np.random.default_rng(9).standard_normal((2, CLIP_DIM)).astype(np.float32)
    shape = sd["inputs"][0].shape  # the fixture's shapes: JAX's eager ops compiled there are reused
    jdec.calibrate_int8_scales(jnp.asarray(z), shape)
    want = sd_unet_quant_from_jax(jdec.unet_quant)
    mods = [tsd.SDUNet(tsd.SDUNetConfig(**UCFG)), tsd.AutoencoderKL(tsd.VAEConfig(**VCFG)),
            tsd.SDClipAdapter(in_dim=CLIP_DIM, ctx_dim=16, n_tokens=2)]
    for m, state in zip(mods, sd["sd"]):
        m.load_state_dict(state, strict=True)
    dec = tsd.StableDiffusionDecoder(*mods, int8=True)
    lat = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)))
    dec.calibrate_int8_scales(torch.from_numpy(z), shape, latents=lat)
    got = dec.unet_quant
    assert set(got) == set(want) == set(q8.int8_layer_names(dec.unet))
    with torch.no_grad():
        ctx_absmax = torch.maximum(dec.adapter(torch.from_numpy(z)).abs().amax(),
                                   dec.adapter(torch.zeros((2, CLIP_DIM))).abs().amax())
    for k in want:
        if k.endswith(("attn2.to_k", "attn2.to_v")):
            # max|context|: the adapter's output, whose 1024-long fp32 products
            # differ from JAX's by reassociation
            assert torch.equal(got[k], ctx_absmax), k
            assert abs(got[k].item() - want[k].item()) <= 2e-6 * want[k].item(), k
        else:
            assert abs(got[k].item() - want[k].item()) <= 1e-6 * want[k].item(), k
    loaded = dec.unet.down_blocks[0].resnets[0].conv1.__dict__["_x_absmax"]
    assert loaded.data_ptr() == got["down_blocks.0.resnets.0.conv1"].data_ptr()  # the layer reads the dict's tensor
    # the GEGLU pair must agree to map onto the one fused projection
    bad = jax.tree_util.tree_map(lambda a: a, jdec.unet_quant)
    g = bad["down_0_attn_0"]["block_0"]["ff_geglu"]["proj_g"]
    g["x_absmax"] = g["x_absmax"] * 2
    with pytest.raises(ValueError, match="proj_h and proj_g"):
        sd_unet_quant_from_jax(bad)
    dec.calibrate_int8_scales(torch.from_numpy(z), shape)  # its own latents: other numbers, the same layers
    assert set(dec.unet_quant) == set(want)


# ------------------------------------------------------------------ switch semantics


def test_state_dict_is_identical_across_the_switch():
    nets = {}
    for on in (False, True):
        q8.set_int8_conv(on)
        nets[on] = init_params(CLIPCondUNet(**CFG, time_dim=256), torch.Generator().manual_seed(0)).state_dict()
    assert nets[False].keys() == nets[True].keys()
    for k in nets[False]:
        assert torch.equal(nets[False][k], nets[True][k]), k


def test_switch_restores_exact_fp_and_explicit_int8_pins(pixel):
    args = [torch.from_numpy(a) for a in pixel["inputs"]]
    default, fp, int8 = (_pixel_port(pixel, torch.float32, int8=v) for v in (None, False, True))
    with torch.no_grad():
        before = default(*args)
        assert torch.equal(before, fp(*args))
        q8.set_int8_conv(True)
        on = default(*args)
        assert not torch.equal(on, before) and torch.equal(on, int8(*args))
        assert torch.equal(fp(*args), before)  # an explicit int8=False ignores the switch
        q8.set_int8_conv(False)
        assert torch.equal(default(*args), before)
        assert torch.equal(int8(*args), on)  # an explicit int8=True ignores it too
        q8.load_quant(int8, q8.calibrate_unet(int8, 16, 8, timesteps=50, batch=2))
        static = int8(*args)
        assert not torch.equal(static, on)
        q8.load_quant(int8, None)
        assert torch.equal(int8(*args), on)  # no quant: the dynamic scales again


def test_vae_stays_fp_and_calibration_needs_int8_layers(sd):
    vae = tsd.AutoencoderKL(tsd.VAEConfig(**VCFG))
    vae.load_state_dict(sd["sd"][1], strict=True)
    lat = torch.from_numpy(sd["inputs"][0][:1])
    with torch.no_grad():
        ref = vae.eval().decode(lat)
        q8.set_int8_conv(True)
        assert torch.equal(vae.decode(lat), ref)
    q8.set_int8_conv(False)
    net = tsd.SDUNet(tsd.SDUNetConfig(**UCFG))
    net.load_state_dict(sd["sd"][0], strict=True)
    batch = [torch.from_numpy(a) for a in sd["inputs"]]
    with pytest.raises(RuntimeError, match="recorded nothing"):
        q8.calibrate_int8(net, batch)
    with pytest.raises(RuntimeError, match="at least one batch"):
        q8.calibrate_int8(net)
    with pytest.raises(ValueError, match="no int8 form"):
        tsd.layers.Downsample2D(8, 8, asymmetric=True)(torch.zeros(1, 4, 4, 8), torch.float32, int8=True)


def test_quant_dicts_load_and_save(pixel, tmp_path):
    net = _pixel_port(pixel, torch.float32, int8=True)
    quant = unet_quant_from_jax(pixel["jquant"], CFG["ch_mult"])
    with pytest.raises(KeyError, match="does not run in int8"):
        q8.load_quant(net, {**quant, "in_conv": torch.tensor(1.0)})
    q8.save_quant(quant, tmp_path / "q.pt")
    back = q8.read_quant(tmp_path / "q.pt")
    assert back.keys() == quant.keys() and all(torch.equal(back[k], quant[k]) for k in quant)
    torch.save({"a": torch.zeros(3)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="not an int8 calibration sidecar"):
        q8.read_quant(tmp_path / "bad.pt")
