"""The port's models (SpectralNet, SpectralDenoiser), their checkpoints, the
weight converter and ``entry()`` against kofft_tpu on the CPU, following
tests/test_models.py.

The same weights, drawn from a numpy seed in the JAX package's layout,
reach both packages (the port's through ``models/convert.py``), and the
same seeded signals go through both; the port's modules get
``device="cpu"``. Widths are the entry's: win 256, hop 128, 32 mel bands,
8 classes; hidden 64 for the denoiser; a (2, 2048) batch. Tolerances:
logits >= 90 dB against the JAX package (measured 137.3 dB); the
denoiser's output interior [win:-win] >= 90 dB, the ISTFT interior's
floor (measured 136.7 dB); ``entry()`` >= 90 dB against the JAX entry
under jit (measured 134.7 dB); initial weights and checkpoints bit-equal.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kofft_tpu.models import SpectralDenoiser as JDen  # noqa: E402
from kofft_tpu.models import SpectralNet as JNet  # noqa: E402
from kofft_tpu.models import checkpoint as JCk  # noqa: E402
from kofft_tpu.models.denoiser import SpectralDenoiserParams as JDP  # noqa: E402
from kofft_tpu.models.spectral_net import SpectralNetParams as JNP  # noqa: E402
import kofft_tpu_torch.models as TM  # noqa: E402
from kofft_tpu_torch.entry import entry as t_entry  # noqa: E402
from kofft_tpu_torch.errors import InvalidValueError  # noqa: E402
from kofft_tpu_torch.models import SpectralDenoiser, SpectralNet  # noqa: E402
from kofft_tpu_torch.models import checkpoint as TCk  # noqa: E402
from kofft_tpu_torch.models import convert as CV  # noqa: E402
from kofft_tpu_torch.ops.dft import snr_db  # noqa: E402

MODEL_DB = 90.0
CPU = {"device": "cpu"}
WIN = 256


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def net_case():
    """JAX SpectralNet weights drawn from the seed (the mel table moved off
    its init, a drawn head and bias), a (2, 2048) signal, and the JAX
    logits under jit."""
    rng = np.random.default_rng(90)
    jn = JNet()
    p0 = jn.init(0)
    params = JNP(
        mel=np.asarray(p0.mel) + 0.01 * rng.standard_normal(
            p0.mel.shape).astype(np.float32),
        w_head=rng.standard_normal(p0.w_head.shape).astype(np.float32),
        b_head=rng.standard_normal(p0.b_head.shape).astype(np.float32))
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    return params, x, np.asarray(jax.jit(jn.apply)(params, x))


@pytest.fixture(scope="module")
def den_case():
    """JAX SpectralDenoiser weights drawn from the seed (w2 and b2 too, so
    the mask is not init's constant sigmoid(2)), a (2, 2048) signal, and
    the JAX output under jit."""
    rng = np.random.default_rng(91)
    jd = JDen()
    p0 = jd.init(0)
    params = JDP(
        w1=np.asarray(p0.w1),
        b1=0.1 * rng.standard_normal(p0.b1.shape).astype(np.float32),
        w2=rng.standard_normal(p0.w2.shape).astype(np.float32) / 8,
        b2=rng.standard_normal(p0.b2.shape).astype(np.float32))
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    return params, x, np.asarray(jax.jit(jd.apply)(params, x))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("which", ["net", "denoiser"])
def test_init_bit_equal(which, seed):
    """init(seed) draws what the JAX package's does, bit for bit, and the
    module's parameters start from init(0)."""
    jm, tm = ((JNet(), SpectralNet(**CPU)) if which == "net"
              else (JDen(), SpectralDenoiser(**CPU)))
    want, got = jm.init(seed), tm.init(seed)
    assert got._fields == want._fields
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(w), g)
    for w, (name, p) in zip(jm.init(0), tm.named_parameters()):
        np.testing.assert_array_equal(np.asarray(w), _np(p))
    assert [n for n, _ in tm.named_parameters()] == list(got._fields)


def test_spectral_net_logits(net_case):
    params, x, want = net_case
    model = SpectralNet(**CPU)
    got = _np(model.apply(CV.spectral_net_params(params), x))
    assert got.shape == (2, 8)
    assert snr_db(want, got) > MODEL_DB
    CV.load_into(model, CV.spectral_net_params(params))
    assert snr_db(want, _np(model(torch.as_tensor(x)))) > MODEL_DB


def test_denoiser_interior(den_case):
    params, x, want = den_case
    model = CV.load_into(SpectralDenoiser(**CPU),
                         CV.denoiser_params(params))
    got = _np(model(x))
    assert got.shape == x.shape
    assert snr_db(want[:, WIN:-WIN], got[:, WIN:-WIN]) > MODEL_DB


def test_forward_is_differentiable(net_case, den_case):
    """Gradients reach every parameter through the STFT (and, for the
    denoiser, the ISTFT), finite."""
    for model, (params, x, _), conv in (
            (SpectralNet(**CPU), net_case, CV.spectral_net_params),
            (SpectralDenoiser(**CPU), den_case, CV.denoiser_params)):
        CV.load_into(model, conv(params))
        model(x).square().mean().backward()
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert p.grad.abs().sum() > 0, name


def test_entry_against_jax():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).resolve().parents[1]
        / "__graft_entry__.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    jfn, jargs = g.entry()
    fn, args = t_entry(**CPU)
    assert len(args) == len(jargs) == 4
    for a, b in zip(args, jargs):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = _np(fn(*args))
    assert got.shape == want.shape == (4, 8)
    assert snr_db(want, got) > MODEL_DB


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_interop(tmp_path, net_case, direction):
    """A file saved by either package loads in the other, bit-equal."""
    params = net_case[0]
    path = tmp_path / "ck.npz"
    if direction == "jax_to_port":
        JCk.save_params(path, params)
        got = TCk.load_params(path, **CPU)
        assert all(g.device.type == "cpu" for g in got)
        got = [_np(g) for g in got]
    else:
        model = CV.load_into(SpectralNet(**CPU),
                             CV.spectral_net_params(params))
        TCk.save_params(path, model.params())
        got = [np.asarray(g) for g in JCk.load_params(path)]
    with np.load(path) as z:
        assert sorted(z.files) == [".b_head", ".mel", ".w_head"]
    for w, g in zip(params, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(w), g)


def test_convert_inputs(tmp_path, den_case):
    """The converter takes a NamedTuple, a mapping with or without the
    pytree's leading dots, or a loaded .npz; a missing field raises."""
    params = den_case[0]
    want = CV.denoiser_params(params)
    np.savez(tmp_path / "d.npz",
             **{f".{k}": v for k, v in params._asdict().items()})
    with np.load(tmp_path / "d.npz") as z:
        from_npz = CV.denoiser_params(z)
    for other in (from_npz, CV.denoiser_params(params._asdict()),
                  CV.denoiser_params({f".{k}": v for k, v
                                      in params._asdict().items()})):
        for w, g in zip(want, other):
            np.testing.assert_array_equal(w, g)
    with pytest.raises(InvalidValueError):
        CV.denoiser_params({"w1": want.w1})
    with pytest.raises(RuntimeError):
        CV.load_into(SpectralNet(**CPU), want)


def test_default_device_is_the_card():
    """Without a card the default device raises instead of computing on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (SpectralNet, SpectralDenoiser, t_entry):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_models_surface():
    """The JAX package's names: the two models and their training steps
    (kofft_tpu/models/__init__.py)."""
    import kofft_tpu.models as JM
    from kofft_tpu_torch.models import denoiser, spectral_net
    public = {n for n in vars(JM) if not n.startswith("_")}
    assert public >= {"SpectralNet", "SpectralDenoiser", "train_step",
                      "denoiser_train_step"}
    assert {n for n in vars(TM) if not n.startswith("_")} >= public
    assert TM.train_step is spectral_net.train_step
    assert TM.denoiser_train_step is denoiser.train_step
