"""The port's training (``loss_fn``, ``train_step``, ``denoiser_train_step``)
against kofft_tpu's on the CPU, following tests/test_models.py.

The same seeded numpy weights and batches go through the JAX package
(``jax.value_and_grad`` of its ``loss_fn`` under jit, and its jitted
``train_step``) and through the port on ``device="cpu"``. Widths are the
entry's: SpectralNet at win 256, hop 128, 32 mel bands, 8 classes on a
(4, 2048) batch; the denoiser at win 256, hop 128, hidden 64 on (2, 2048).
Weights: ``init(0)`` (six of SpectralNet's 32 mel bands are empty there,
and the denoiser's ``w2`` is zero) and drawn off init. Floors: losses
>= 110 dB; the ``mel`` gradient >= 80 dB (the leaf is ill-conditioned:
d log(|mel| + 1e-6) reaches 1e6 where a mel product is near 0); every
other gradient leaf >= 100 dB; the parameters and losses after 5 steps
>= 80 dB.

SpectralNet's steps from the drawn-head point ``off`` (mel + 0.01 N(0,1),
so some mel products pass near 0, where log(|x| + 1e-6) is singular; a
unit-variance head and a large loss) are unstable in float32: a float32 run
leaves a float64 one within a few steps (``tools/train_trajectory.py
--batch 4 --samples 2048 --point off``: the mel table 100.1 dB against
float64 after 1 step, 79.6 after 2, 52.8 after 5), and two float32 runs
(JAX's and the port's) part the same way (ROADMAP C.3). That point is
held after 1 step, and the 5 steps run from ``steady`` (mel + 0.01
|N(0,1)|, a head at init's scale; 140.5-154.2 dB against float64
through 5 steps, ``--point steady``) and from ``init(0)``.

The kernel route (``set_backend("cuda")``, whose wrappers run their plain
versions on CPU tensors) is held at win 2^14 against the JAX package's
plain engines: >= 100 dB on `highest`, the tier's 42 dB on `default` (the
forward STFT reads bf16 planes there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kofft_tpu as jk  # noqa: E402
from kofft_tpu.models import SpectralDenoiser as JDen  # noqa: E402
from kofft_tpu.models import SpectralNet as JNet  # noqa: E402
from kofft_tpu.models import denoiser as JD  # noqa: E402
from kofft_tpu.models import denoiser_train_step as j_den_step  # noqa: E402
from kofft_tpu.models import spectral_net as JS  # noqa: E402
from kofft_tpu.models import train_step as j_net_step  # noqa: E402
import kofft_tpu_torch as kt  # noqa: E402
import kofft_tpu_torch.models as TM  # noqa: E402
from kofft_tpu_torch.config import precision_scope  # noqa: E402
from kofft_tpu_torch.errors import InvalidValueError  # noqa: E402
from kofft_tpu_torch.models import denoiser as TD  # noqa: E402
from kofft_tpu_torch.models import spectral_net as TS  # noqa: E402
from kofft_tpu_torch.ops import hopper_fft as HF  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

LOSS_DB = 110.0
MEL_DB = 80.0
GRAD_DB = 100.0
STEPS_DB = 80.0
DEFAULT_DB = 42.0
CPU = {"device": "cpu"}
# (model, weights, steps) of the train_step comparison (see above)
STEP_CASES = [("net", "init", 5), ("net", "steady", 5), ("net", "off", 1),
              ("denoiser", "init", 5), ("denoiser", "off", 5)]


def _np(t):
    return t.detach().numpy()


def _net_params(which):
    """SpectralNet weights as float32 numpy: ``init(0)``; ``off``, the mel
    table moved off its init by 0.01 N(0,1) with a unit-variance head and
    bias; ``steady``, moved by 0.01 |N(0,1)| (no band empty, no product
    near 0) with a head at init's scale and a bias of 0.1 N(0,1)."""
    p = [np.asarray(a) for a in JNet().init(0)]
    rng = np.random.default_rng({"init": 0, "off": 120, "steady": 125}[which])
    draw = rng.standard_normal
    if which == "off":
        p = [p[0] + 0.01 * draw(p[0].shape).astype(np.float32),
             draw(p[1].shape).astype(np.float32),
             draw(p[2].shape).astype(np.float32)]
    elif which == "steady":
        p = [p[0] + 0.01 * np.abs(draw(p[0].shape)).astype(np.float32),
             (draw(p[1].shape) / np.sqrt(32)).astype(np.float32),
             0.1 * draw(p[2].shape).astype(np.float32)]
    return JS.SpectralNetParams(*p)


def _den_params(which, win=256, hidden=64):
    """Denoiser weights as float32 numpy: ``init(0)``, or with ``b1``,
    ``w2`` and ``b2`` drawn (at init the mask is the constant sigmoid(2)
    and the first layer's gradient is zero)."""
    p = [np.asarray(a) for a in JDen(win, win // 2, hidden).init(0)]
    if which == "off":
        rng = np.random.default_rng(121)
        p[1:] = [0.1 * rng.standard_normal(p[1].shape).astype(np.float32),
                 rng.standard_normal(p[2].shape).astype(np.float32) / 8,
                 rng.standard_normal(p[3].shape).astype(np.float32)]
    return JD.SpectralDenoiserParams(*p)


def _net_batch():
    rng = np.random.default_rng(122)
    return (rng.standard_normal((4, 2048)).astype(np.float32),
            rng.integers(0, 8, 4).astype(np.int32))


def _den_batch(n=2048, b=2, seed=123):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


def _jax_value_and_grad(loss, model, params, a, b):
    lv, g = jax.jit(jax.value_and_grad(
        lambda p: loss(model, p, a, b)))(params)
    return np.asarray(lv), [np.asarray(x) for x in g]


def _port_value_and_grad(loss, model, params, a, b):
    leaves = type(params)(*(torch.tensor(np.asarray(p)).requires_grad_()
                            for p in params))
    lv = loss(model, leaves, a, b)
    return _np(lv), [_np(g) for g in torch.autograd.grad(lv, leaves)]


def _jax_steps(step, model, params, a, b, lr, steps):
    p = type(params)(*(jnp.asarray(x) for x in params))
    losses = []
    for _ in range(steps):
        p, lv = step(model, p, a, b, lr)
        losses.append(float(lv))
    return [np.asarray(x) for x in p], losses


def _port_steps(step, model, params, a, b, lr, steps):
    p, losses = params, []
    for _ in range(steps):
        p, lv = step(model, p, a, b, lr)
        losses.append(float(lv))
    return [_np(x) for x in p], losses


# (JAX loss, port loss, JAX step, port step, lr of the steps): the JAX
# tests' rates (tests/test_models.py: 1e-3 for SpectralNet, 1.0 for the
# denoiser)
GRAD_CASES = [("net", "init"), ("net", "off"), ("net", "steady"),
              ("denoiser", "init"), ("denoiser", "off")]
CASES = {
    "net": (JS.loss_fn, TS.loss_fn, j_net_step, TM.train_step, 1e-3),
    "denoiser": (JD.loss_fn, TD.loss_fn, j_den_step,
                 TM.denoiser_train_step, 1.0),
}


def _jax_case(name, which):
    if name == "net":
        return JNet(), _net_params(which), *_net_batch()
    return JDen(), _den_params(which), *_den_batch()


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients per (model, weights)."""
    return {(name, which): _jax_value_and_grad(CASES[name][0],
                                               *_jax_case(name, which))
            for name, which in GRAD_CASES}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's parameters and losses after its jitted
    train_steps, per STEP_CASES entry."""
    return {case: _jax_steps(CASES[case[0]][2], *_jax_case(*case[:2]),
                             CASES[case[0]][4], case[2])
            for case in STEP_CASES}


def _port_case(name, which):
    if name == "net":
        return (TM.SpectralNet(**CPU), _net_params(which), *_net_batch())
    return (TM.SpectralDenoiser(**CPU), _den_params(which), *_den_batch())


def _hold_grads(fields, want, got):
    for f, w, g in zip(fields, want, got):
        floor = MEL_DB if f == "mel" else GRAD_DB
        assert g.shape == w.shape and g.dtype == np.float32, f
        assert snr_db(w, g) >= floor, (f, snr_db(w, g))


@pytest.mark.parametrize("name,which", GRAD_CASES)
def test_loss_and_gradients_match_jax(jax_grads, name, which):
    """loss_fn and its gradient over every params field against
    jax.value_and_grad of the JAX package's loss_fn."""
    want_l, want_g = jax_grads[name, which]
    model, params, a, b = _port_case(name, which)
    got_l, got_g = _port_value_and_grad(CASES[name][1], model, params, a, b)
    assert got_l.shape == () and np.isfinite(got_l)
    assert snr_db(want_l, got_l) >= LOSS_DB
    _hold_grads(params._fields, want_g, got_g)


@pytest.mark.parametrize("name,which,steps", STEP_CASES)
def test_train_steps_match_jax(jax_steps, name, which, steps):
    """train_steps from numpy params: every loss and every parameter
    against the JAX package's jitted train_step (the first loss at the
    loss floor)."""
    want_p, want_losses = jax_steps[name, which, steps]
    model, params, a, b = _port_case(name, which)
    got_p, got_losses = _port_steps(CASES[name][3], model, params, a, b,
                                    CASES[name][4], steps)
    assert snr_db(want_losses[0], got_losses[0]) >= LOSS_DB
    for w, g in zip(want_losses, got_losses):
        assert snr_db(w, g) >= STEPS_DB, (want_losses, got_losses)
    for f, w, g in zip(params._fields, want_p, got_p):
        assert snr_db(w, g) >= STEPS_DB, (f, snr_db(w, g))


def test_abs_derivative_at_zero_matches_jax():
    """At init(0), win 256 and 32 mel bands, six filterbank columns are
    all zero, so the mel projection is exactly 0 there and the log-mel
    takes the derivative of |x| at 0: +1 in JAX (select(x >= 0, g, -g)),
    0 for torch.abs. The port follows JAX."""
    params = _net_params("init")
    assert np.count_nonzero(~params.mel.any(axis=0)) == 6
    x, y = _net_batch()
    _, want = _jax_value_and_grad(JS.loss_fn, JNet(), params, x, y)
    _, got = _port_value_and_grad(TS.loss_fn, TM.SpectralNet(**CPU),
                                  params, x, y)
    assert snr_db(want[0], got[0]) >= MEL_DB, snr_db(want[0], got[0])


def test_abs_value_and_derivative():
    """The log-mel's magnitude: torch.abs's value (-0.0 and nan included)
    and JAX's derivative, +1 at 0."""
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0, float("nan")],
                     requires_grad=True)
    v = TS._abs(x)
    np.testing.assert_array_equal(_np(v), _np(torch.abs(x)))
    (g,) = torch.autograd.grad(v.nansum(), x)
    want = np.asarray(jax.grad(lambda t: jnp.nansum(jnp.abs(t)))(
        jnp.asarray(_np(x))))
    np.testing.assert_array_equal(_np(g)[:4], want[:4])
    np.testing.assert_array_equal(_np(g)[:4], [-1.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("labels", [[-1, 8, 3, 100], [0, 7, 9, -5]])
def test_out_of_range_labels_match_jax(labels):
    """jax.nn.one_hot gives a row of zeros for a label outside [0, C):
    those rows add 0 to the sum and still count in the mean. The port's
    loss and gradients equal the JAX package's there (torch's one_hot
    would raise)."""
    params = _net_params("off")
    x, _ = _net_batch()
    y = np.asarray(labels, np.int32)
    want_l, want_g = _jax_value_and_grad(JS.loss_fn, JNet(), params, x, y)
    got_l, got_g = _port_value_and_grad(TS.loss_fn, TM.SpectralNet(**CPU),
                                        params, x, torch.as_tensor(y))
    assert snr_db(want_l, got_l) >= LOSS_DB
    _hold_grads(params._fields, want_g, got_g)


@pytest.mark.parametrize("n", [512, 300])
def test_denoiser_loss_guard(n):
    """A signal no longer than 2 * win_len leaves no interior to score:
    the loss and the step raise InvalidValueError with the JAX message."""
    model = TM.SpectralDenoiser(**CPU)
    x = np.zeros((1, n), np.float32)
    with pytest.raises(InvalidValueError, match="longer than 2\\*win_len"):
        TD.loss_fn(model, model.params(), x, x)
    with pytest.raises(InvalidValueError, match="= 512"):
        TM.denoiser_train_step(model, model.init(0), x, x)


def test_train_step_params_and_outputs():
    """Params as numpy, as tensors or as the module's own parameters give
    the same step; the module's parameters are neither written nor given
    a .grad; the new params are fresh float32 tensors and the loss a 0-d
    tensor, with autograd off outside the step."""
    model = TM.SpectralNet(**CPU)
    x, y = _net_batch()
    before = [_np(p).copy() for p in model.parameters()]
    runs = []
    for params in (model.init(0), TS.SpectralNetParams(
            *(torch.tensor(a) for a in model.init(0))), model.params()):
        with torch.no_grad():
            new, lv = TM.train_step(model, params, x, y)
        assert isinstance(new, TS.SpectralNetParams)
        assert lv.dim() == 0 and lv.device.type == "cpu"
        assert not lv.requires_grad
        for p, q in zip(new, model.parameters()):
            assert p.dtype == torch.float32 and not p.requires_grad
            assert p.data_ptr() != q.data_ptr()
        runs.append(([_np(p) for p in new], float(lv)))
    for p, b in zip(model.parameters(), before):
        np.testing.assert_array_equal(_np(p), b)
        assert p.grad is None
    for new, lv in runs[1:]:
        assert lv == runs[0][1]
        for a, b in zip(new, runs[0][0]):
            np.testing.assert_array_equal(a, b)
    # a tensor batch computes where it lies (host input on the model's
    # device), and any sequence of the fields is taken
    new, lv = TM.train_step(model, list(model.init(0)), torch.as_tensor(x),
                            torch.as_tensor(y))
    assert isinstance(new, TS.SpectralNetParams)
    assert float(lv) == runs[0][1]


# ----------------------------------------------- tests/test_models.py's three

def test_train_step_reduces_loss():
    """The counterpart of test_models.py::test_train_step_reduces_loss."""
    model = TM.SpectralNet(win_len=64, hop=32, n_mel=8, n_classes=4, **CPU)
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    y = rng.integers(0, 4, 8).astype(np.int32)
    params, losses = model.init(0), []
    for _ in range(20):
        params, lv = TM.train_step(model, params, x, y, 1e-3)
        losses.append(float(lv))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses[-1])


def test_gradients_flow_through_stft():
    """The counterpart of test_models.py::test_gradients_flow_through_stft,
    the input gradient also held against jax.grad (>= 100 dB)."""
    jm = JNet(win_len=64, hop=32, n_mel=8, n_classes=4)
    model = TM.SpectralNet(win_len=64, hop=32, n_mel=8, n_classes=4, **CPU)
    params = jm.init(0)
    x = np.random.default_rng(1235).standard_normal((2, 512)).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda xx: jm.apply(params, xx).sum()))(x))
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(model.apply(model.init(0), xt).sum(), xt)
    assert g.shape == xt.shape
    assert g.abs().max() > 0
    assert snr_db(want, _np(g)) >= GRAD_DB


def test_denoiser_training_reduces_loss():
    """The counterpart of test_models.py::test_denoiser_training_reduces_
    loss: a tone and a tonal interferer in other bins; 60 steps at lr 1
    bring the loss under 0.3 of its start."""
    model = TM.SpectralDenoiser(win_len=128, hop=64, hidden=32, **CPU)
    params = model.init(seed=0)
    t = np.arange(2048)
    clean = np.sin(2 * np.pi * 4 * t / 128).astype(np.float32)[None, :]
    noisy = clean + (0.8 * np.sin(2 * np.pi * 37 * t / 128 + 0.7)
                     ).astype(np.float32)[None, :]
    l0 = float(TD.loss_fn(model, params, noisy, clean))
    for _ in range(60):
        params, lv = TM.denoiser_train_step(model, params, noisy, clean,
                                            lr=1.0)
    assert float(lv) < 0.3 * l0


# ---------------------------------------------------------- the kernel route

@pytest.fixture(scope="module")
def kernel_case():
    """The denoiser at win 2^14, hop 2^13, hidden 64 on a (1, 2^16) batch
    (8 two-sided frames of 2^14 per STFT and ISTFT, the stage kernels'
    size), weights off init, and the JAX package's loss and gradients on
    its plain engines (backend "xla") on each tier."""
    win = 1 << 14
    params = _den_params("off", win)
    noisy, clean = _den_batch(1 << 16, 1, 124)
    model = JDen(win, win // 2, 64)
    ref = {}
    jk.set_backend("xla")
    try:
        for tier in ("highest", "default"):
            jk.set_precision(tier)
            ref[tier] = _jax_value_and_grad(JD.loss_fn, model, params,
                                            noisy, clean)
    finally:
        jk.set_backend(None)
        jk.set_precision(None)
    return params, noisy, clean, ref


@pytest.mark.parametrize("tier", ["highest", "default"])
def test_kernel_route_gradient(kernel_case, monkeypatch, tier):
    """backend "cuda": the STFT, the ISTFT's synthesis and the synthesis's
    backward take the stage kernels' route. The backward runs at its
    forward's tier: on `default` the synthesis is lifted to `high`, and
    its backward (a forward transform, run by autograd after the lift is
    undone) reads `high` too, not the bf16 casts of `default`."""
    params, noisy, clean, ref = kernel_case
    want_l, want_g = ref[tier]
    seen = []
    real_fft = HF.fused_multilevel_fft

    def spy(xr, xi, n, inverse=False, donate=False):
        seen.append((kt.get_config().precision, bool(inverse)))
        return real_fft(xr, xi, n, inverse, donate=donate)

    monkeypatch.setattr(HF, "fused_multilevel_fft", spy)
    model = TM.SpectralDenoiser(1 << 14, 1 << 13, 64, **CPU)
    kt.set_backend("cuda")
    kt.set_precision(tier)
    try:
        leaves = type(params)(*(torch.tensor(p).requires_grad_()
                                for p in params))
        lv = TD.loss_fn(model, leaves, noisy, clean)
        forward = list(seen)
        got = torch.autograd.grad(lv, leaves)
    finally:
        kt.set_backend(None)
        kt.set_precision(None)
    lift = "high" if tier == "default" else tier
    assert forward == [(tier, False), (lift, True)]
    assert seen[2:] == [(lift, False)]
    floor = GRAD_DB if tier == "highest" else DEFAULT_DB
    assert snr_db(want_l, _np(lv)) >= (LOSS_DB if tier == "highest"
                                       else DEFAULT_DB)
    for f, w, g in zip(params._fields, want_g, got):
        assert snr_db(w, _np(g)) >= floor, (f, snr_db(w, _np(g)))


def test_precision_scope_restores_on_raise():
    """The scope a backward runs in restores the caller's tier, also when
    the block raises."""
    kt.set_precision("default")
    try:
        with pytest.raises(RuntimeError):
            with precision_scope("highest"):
                assert kt.get_config().precision == "highest"
                raise RuntimeError
        assert kt.get_config().precision == "default"
        with precision_scope("default"):
            assert kt.get_config().precision == "default"
    finally:
        kt.set_precision(None)
