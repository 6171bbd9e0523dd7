"""The counterparts of ``__graft_entry__``: ``entry()``, the forward step
of the flagship model, SpectralNet at win 256, hop 128, 32 mel bands and
8 classes, on a (4, 4096) signal, and ``dryrun_multichip(n)``, a training
step and the sharded programs on n gloo ranks of the host's CPU.

    fn, args = entry()        # on the card; entry("cpu") on the CPU
    logits = fn(*args)        # (4, 8)
    python -c "from kofft_tpu_torch.entry import dryrun_multichip as d; d(4)"
"""

from __future__ import annotations

import numpy as np
import torch

from .models.spectral_net import SpectralNet, SpectralNetParams
from .ops._complex import host_device


def entry(device="cuda"):
    """(fn, args): ``fn(mel, w_head, b_head, signal)`` runs SpectralNet's
    forward on those tensors; ``args`` are the JAX entry's four arguments
    (``init(seed=0)`` and a seed-0 signal) as tensors on ``device``."""
    dev = host_device(device)
    model = SpectralNet(win_len=256, hop=128, n_mel=32, n_classes=8,
                        device=dev)
    params = model.init(seed=0)

    def fn(mel, w_head, b_head, signal):
        return model.apply(SpectralNetParams(mel, w_head, b_head), signal)

    rng = np.random.default_rng(0)
    signal = rng.standard_normal((4, 4096)).astype(np.float32)
    return fn, tuple(torch.as_tensor(a, device=dev)
                     for a in (*params, signal))


class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` in the forward. The backward sums the gradient
    over the group too when each rank's downstream reads only part of the
    sum (``reduce_grad``), else passes it through (every rank computes
    the same downstream)."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad: bool):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = g.clone()
            torch.distributed.all_reduce(g, group=ctx.group)
        return g, None, None


def _tp_loss(model, mel_j, w_j, b, signal, labels, j: int, tp_group):
    """The loss of a SpectralNet forward whose mel bands are split over the
    tensor-parallel ranks: rank j holds ``mel``'s columns and ``w_head``'s
    rows of its bands. The DCT's partial sums over the bands (every rank
    then reads its bands of the pooled features) and the head's partial
    logits are summed over the ranks."""
    from .models.spectral_net import _abs
    from .ops._complex import const
    from .ops.dct import _matrix as _dct_matrix
    from .ops.stft import stft_split
    m = mel_j.shape[1]
    fr, fi = stft_split(signal, model.window, model.hop, onesided=True,
                        backend="torch", device="cpu")
    mags = torch.sqrt(fr * fr + fi * fi + 1e-12)
    logmel = torch.log(_abs(torch.matmul(mags, mel_j)) + 1e-6)
    dct = const(_dct_matrix(2, model.n_mel, "float32"), logmel.device)
    part = torch.matmul(logmel, dct[j * m:(j + 1) * m]).mean(dim=-2)
    pooled = _AllReduce.apply(part, tp_group, True)
    logits = _AllReduce.apply(
        torch.matmul(pooled[:, j * m:(j + 1) * m], w_j), tp_group, False) + b
    logp = torch.log_softmax(logits, dim=-1)
    lab = torch.as_tensor(labels)
    onehot = (lab[:, None] == torch.arange(model.n_classes)).to(logp.dtype)
    return -(onehot * logp).sum(dim=-1).mean()


def _dryrun_rank(n: int) -> dict:
    """One rank of ``dryrun_multichip``'s gloo world: the dp x tp training
    step, then the collective programs and their audits."""
    import torch.distributed as dist

    from . import parallel as P
    from .models.spectral_net import SpectralNet
    from .ops import window as W
    from .parallel import validate as V
    from .parallel.fft_sharded import _split_for_mesh
    from .parallel.mesh import _mesh

    def snr(ref, got):
        ref = np.asarray(ref, np.complex128)
        return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                             / np.sum(np.abs(ref - got) ** 2))

    def host(y):
        return (y[0].full_tensor().numpy() + 1j * y[1].full_tensor().numpy()
                if isinstance(y, tuple) else y.full_tensor().numpy())

    # ---- dp x tp training step (one SGD step at lr 1e-2) ---------------
    dp = max(1, n // 2)
    tp = n // dp
    mesh2 = _mesh((dp, tp), ("dp", "tp"), "cpu")
    i, j = mesh2.get_local_rank("dp"), mesh2.get_local_rank("tp")
    model = SpectralNet(win_len=64, hop=32, n_mel=4 * tp, n_classes=8,
                        device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    batch = dp * 2
    signal = rng.standard_normal((batch, 256)).astype(np.float32)
    labels = rng.integers(0, 8, size=(batch,)).astype(np.int32)
    m = model.n_mel // tp
    rows = slice(i * 2, (i + 1) * 2)
    leaves = [torch.tensor(a).requires_grad_() for a in (
        params.mel[:, j * m:(j + 1) * m], params.w_head[j * m:(j + 1) * m],
        params.b_head)]
    loss = _tp_loss(model, *leaves, torch.as_tensor(signal[rows]),
                    labels[rows], j, mesh2.get_group("tp"))
    grads = torch.autograd.grad(loss, leaves)
    dp_group = mesh2.get_group("dp")
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=dp_group)
    new = []
    for p, g in zip(leaves, grads):
        g = g.clone()
        dist.all_reduce(g, group=dp_group)
        new.append((p - 1e-2 * g / dp).detach().numpy())
    loss = float(loss) / dp
    assert np.isfinite(loss), "training loss is not finite"

    # ---- collective transform paths (1-D mesh), against float64 --------
    mesh1 = P.make_mesh(n, device="cpu")
    xr = rng.standard_normal((n * 4, 8, n * 2)).astype(np.float32)
    got = host(P.fftn_sharded(xr, np.zeros_like(xr), mesh=mesh1,
                              restore_layout=True))
    assert snr(np.fft.fftn(xr.astype(np.float64)), got) > 95, "fftn_sharded"
    win, hop = 32, 16
    w = W.hann(win)
    sig = rng.standard_normal(n * 8 * hop).astype(np.float32)
    fr, fi = P.stft_sharded(sig, w, hop, mesh=mesh1)
    out = host(P.istft_sharded(fr, fi, w, hop, mesh=mesh1))
    assert snr(sig[win:-win], out[win:-win]) > 95, "stft/istft_sharded"
    mm = n * n * 16
    z = rng.standard_normal(mm).astype(np.float32)
    got = host(P.fft_sharded(z, np.zeros(mm, np.float32), mesh=mesh1,
                             restore_layout=True))
    assert snr(np.fft.fft(z.astype(np.float64)), got) > 95, "fft_sharded"
    # the overlap pipeline and its audits: the canonical volume, 2K
    # all_to_alls issued before the first wait
    m2 = (2 * n) ** 2
    z2 = rng.standard_normal(m2).astype(np.float32)
    got = host(P.fft_sharded(z2, np.zeros(m2, np.float32), mesh=mesh1,
                             restore_layout=True, overlap=2))
    assert snr(np.fft.fft(z2.astype(np.float64)), got) > 95, "overlap=2"
    rep = V.check_fft_sharded_comm_volume(m2, mesh1, restore_layout=True,
                                          overlap=2)
    assert rep["independent_sources"] == 4, rep

    # ---- the (slice, chip) hierarchy ------------------------------------
    if n >= 4 and n % 2 == 0:
        hm = P.make_hier_mesh(2, n // 2, device="cpu")
        mh = (2 * n) ** 2
        zh = rng.standard_normal(mh).astype(np.float32)
        got = host(P.fft_sharded_hier(zh, np.zeros(mh, np.float32),
                                      mesh=hm))
        assert snr(np.fft.fft(zh.astype(np.float64)), got) > 95, "hier fft"
        gh = rng.standard_normal((n * 2, 4, n * 2)).astype(np.float32)
        got = host(P.fftn_sharded_hier(gh, np.zeros_like(gh), mesh=hm,
                                       restore_layout=True))
        assert snr(np.fft.fftn(gh.astype(np.float64)), got) > 95, \
            "hier fftn"
        sp = _split_for_mesh(mh, n)
        zeros = np.zeros(mh, np.float32)
        with V.comm_log() as log:
            P.fft_sharded_hier(zeros, zeros, mesh=hm, n1=sp[0])
        per = V.a2a_bytes_by_group_size(log)
        leg = 3 * 2 * (mh // n) * 4
        cps = n // 2
        # at n = 4 both tiers have groups of 2 and merge
        want = {2: 2 * leg} if cps == 2 else {cps: leg, 2: leg}
        assert per == want, per
        # the tiered halo: in-slice halos ride ICI, each slice boundary
        # crosses DCN once
        sig2 = rng.standard_normal(n * 8 * hop).astype(np.float32)
        hfr, hfi = P.stft_sharded_hier(sig2, w, hop, mesh=hm)
        hout = host(P.istft_sharded_hier(hfr, hfi, w, hop, mesh=hm))
        assert snr(sig2[win:-win], hout[win:-win]) > 95, "hier stft/istft"
        with V.comm_log() as log:
            P.stft_sharded_hier(np.zeros(n * 8 * hop, np.float32), w, hop,
                                mesh=hm)
        logs = [None] * n
        dist.all_gather_object(logs, log)
        halo_b = (win - hop) * 4
        hper = V.send_bytes_by_tier(logs)
        assert hper == {"ici": 2 * (n // 2 - 1) * halo_b,
                        "dcn": halo_b}, hper
    return {"rank": (i, j), "loss": loss, "dp": dp, "tp": tp,
            "mel": new[0], "w_head": new[1], "b_head": new[2]}


def dryrun_multichip(n_devices: int) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: on
    ``n_devices`` gloo ranks of this host's CPU (``parallel._spawn``), one
    SGD step (lr 1e-2) of SpectralNet (win 64, hop 32, 4 * tp mel bands,
    8 classes) on a dp x tp mesh, dp = n // 2: the batch (2 * dp signals
    of 256 samples) split over dp, ``mel``'s columns and ``w_head``'s rows
    over tp, ``b_head`` replicated; the partial sums over the bands are
    all-reduced over tp and the gradients over dp, which computes the
    step GSPMD computes for those shardings. Then the sharded N-D FFT,
    STFT/ISTFT and 1-D FFT, the overlap pipeline with its audit, and for
    n >= 4 the (2, n/2) hierarchy with its per-tier audits, each held
    against float64 numpy. Prints the JAX dry run's closing line and
    returns the loss, the (dp, tp) layout and the updated parameters."""
    from .parallel import _spawn
    res = _spawn.run(_dryrun_rank, n_devices, n_devices, timeout=300.0)
    first = res[0]
    tp = first["tp"]
    by_j = {r["rank"][1]: r for r in res if r["rank"][0] == 0}
    out = {"loss": first["loss"], "dp": first["dp"], "tp": tp,
           "mel": np.concatenate([by_j[j]["mel"] for j in range(tp)], 1),
           "w_head": np.concatenate([by_j[j]["w_head"] for j in range(tp)]),
           "b_head": first["b_head"]}
    print(f"dryrun_multichip({n_devices}): train_step loss="
          f"{out['loss']:.4f}; sharded NDFFT/STFT/ISTFT/1-D FFT + "
          f"overlap pipeline + (slice,chip) hierarchy incl. tiered-halo "
          f"STFT OK (mesh dp={out['dp']} tp={tp})")
    return out
