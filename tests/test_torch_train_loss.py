"""The port's training loss and gradients against ``jax.grad`` of the
reference's ``DecoderLM.loss``.

Both models start from weights initialised by JAX (``params_from_jax``) and
take the same numpy batch: two documents packed per row, positions
restarting at each, and masked (-1) labels at padding and at a few other
places.  The reference runs the runtime its training driver pins
(``launch/train.py``: fp32 compute, ``attn_impl="naive"``, ``ssd_impl="xla"``,
``rglru_impl="xla"``), the port its counterparts (``"ref"``, ``"chunked"``,
``"scan"``).  Every parameter gradient, restacked with ``params_to_jax``,
must match at fp32 3e-4 (tests/test_kernels.py::_tol).

mamba2 (smoke config, ssm_chunk 16) runs S = 32, two chunks, so the SSD's
state passing is in the backward pass; recurrentgemma runs 5 layers (one
scanned (rec, rec, local) superblock and two unscanned tail layers) at S = 48
against a local window of 32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.models.decoder import xent_loss  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
# The runtime of each package's training driver.
JAX_TRAIN_RT = dict(compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla",
                    rglru_impl="xla")
TORCH_TRAIN_RT = dict(compute_dtype=torch.float32, attn_impl="ref",
                      ssd_impl="chunked", rglru_impl="scan")
CASES = {"mamba2-1.3b": dict(n_layers=2, S=32),
         "recurrentgemma-9b": dict(n_layers=5, S=48)}


def packed_batch(seed, B, S, vocab=512):
    """A loader-shaped batch: two documents a row, positions restarting at
    each, padding (segment -1) at the end of odd rows, labels masked there
    and at random places."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, size=(B, S + 1)).astype(np.int32)
    segments = np.zeros((B, S), np.int32)
    positions = np.zeros((B, S), np.int32)
    for b in range(B):
        cut = int(rng.integers(S // 4, 3 * S // 4))
        segments[b, cut:] = 1
        positions[b] = np.concatenate([np.arange(cut), np.arange(S - cut)])
        if b % 2:
            segments[b, -5:] = -1
    labels = np.where(segments >= 0, tokens[:, 1:], -1)
    labels[rng.random((B, S)) < 0.1] = -1
    return {"tokens": tokens[:, :S], "labels": labels.astype(np.int32),
            "segments": segments, "positions": positions}


def _torch_model(arch, **rt):
    tcfg = dataclasses.replace(get_smoke_config(arch), n_layers=CASES[arch]["n_layers"])
    return build_model(tcfg, RuntimeConfig(**TORCH_TRAIN_RT, **rt), device="cpu",
                       seed=1)


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), n_layers=CASES[arch]["n_layers"])
    jmodel = jax_build_model(jcfg, JaxRuntimeConfig(**JAX_TRAIN_RT))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = _torch_model(arch)
    tmodel.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel


def _torch_loss_and_grads(tmodel, batch):
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = dict(tmodel.named_parameters())
    loss, aux = tmodel.loss(tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, aux, dict(zip(params, grads))


@pytest.mark.parametrize("arch", sorted(CASES))
def test_loss_and_every_gradient_match_jax(arch):
    jmodel, jparams, tmodel = _models(arch)
    batch = packed_batch(0, 4, CASES[arch]["S"])
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux, grads = _torch_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"]) == int((batch["labels"] >= 0).sum())
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = params_to_jax(grads, len(tmodel.pattern))
    n = 0
    for path, leaf in want:
        node = got
        for p in path:
            node = node[p.key]
        assert node.shape == leaf.shape, path
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree.leaves(got)) > 0


@pytest.mark.parametrize("arch", sorted(CASES))
def test_full_remat_gives_the_same_loss_and_gradients(arch):
    plain, remat = _torch_model(arch), _torch_model(arch, remat="full")
    batch = packed_batch(1, 2, CASES[arch]["S"])
    loss_a, _, grads_a = _torch_loss_and_grads(plain, batch)
    loss_b, _, grads_b = _torch_loss_and_grads(remat, batch)
    assert torch.equal(loss_a, loss_b)
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name


def test_remat_dots_and_unknown_modes_are_refused():
    """remat="dots" builds now (its values are held in
    tests/test_torch_remat.py); an unknown mode is still refused."""
    cfg = get_smoke_config("mamba2-1.3b")
    assert build_model(cfg, RuntimeConfig(remat="dots"), device="cpu").rt.remat == "dots"
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, RuntimeConfig(remat="some"), device="cpu")


def test_xent_loss_masks_labels_and_counts_tokens():
    from repro.models.decoder import xent_loss as jax_xent_loss
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2] = -1
    loss, aux = xent_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    jloss, jaux = jax_xent_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert int(aux["n_tokens"]) == int(jaux["n_tokens"]) == 11
    # every label masked: the loss is 0, over a count clamped to 1
    loss, aux = xent_loss(torch.from_numpy(logits), torch.full((3, 7), -1))
    assert loss.item() == 0.0 and int(aux["n_tokens"]) == 1


@pytest.mark.parametrize("op", ["ssd", "rglru", "flash_attention"])
def test_kernel_routes_refuse_inputs_that_require_grad(op):
    """The Hopper kernels are forward-only: their wrappers refuse inputs that
    need a gradient, before they look at the device, and name the plain
    version that training uses."""
    rng = np.random.default_rng(3)

    def t(*shape, grad=False):
        return torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32)
                                ).requires_grad_(grad)

    if op == "ssd":
        from repro_torch.kernels.ssd import ssd
        call, plain = (lambda: ssd(t(1, 8, 2, 16, grad=True), t(1, 8, 2),
                                   t(1, 8, 16), t(1, 8, 16), impl="cuda"),
                       'impl="chunked"')
    elif op == "rglru":
        from repro_torch.kernels.rglru import rglru
        call, plain = (lambda: rglru(t(1, 8, 16), t(1, 8, 16), t(1, 8, 16),
                                     t(16, grad=True), impl="cuda"), 'impl="scan"')
    else:
        from repro_torch.kernels.flash_attention import flash_attention
        call, plain = (lambda: flash_attention(t(1, 8, 2, 16), t(1, 8, 1, 16, grad=True),
                                               t(1, 8, 1, 16), impl="cuda"), 'impl="ref"')
    with pytest.raises(RuntimeError, match="forward-only") as err:
        call()
    assert plain in str(err.value)
    with torch.no_grad(), pytest.raises(ValueError, match="needs CUDA tensors"):
        call()                      # without grad, the device check speaks


@pytest.mark.parametrize("a_lo,ref_finite", [(0.5, True), (0.05, False)])
def test_ssd_gradient_stays_finite_where_the_reference_overflows(a_lo, ref_finite):
    """A hazard of the reference, pinned: ``_ssd_xla`` takes exp(la_t - la_r)
    over the whole chunk and masks it afterwards, so once a chunk's decays
    sum past ~88 in log space the masked entries are inf and ``jax.grad``
    turns NaN (log a for a in (0.05, 0.075) sums to ~-356 over 128 steps;
    for a in (0.5, 0.75) to ~-61).  The port masks before the exp: its forward
    values are the same, its gradients finite, and where the reference's
    are finite they agree (d/dx; see below for d/da)."""
    from repro.kernels.ssd.ops import _ssd_xla
    from repro_torch.kernels.ssd.ops import _ssd_chunked
    rng = np.random.default_rng(4)
    B, S, H, P, N = 1, 128, 2, 8, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = rng.uniform(a_lo, a_lo * 1.5, (B, S, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    s0 = np.zeros((B, H, P, N), np.float32)

    def jloss(x, a):
        y, final = _ssd_xla(x, a, jnp.asarray(Bm), jnp.asarray(Cm), jnp.asarray(s0),
                            chunk=128)
        return (y ** 2).sum() + final.sum()

    jgx, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    xt, at = (torch.from_numpy(v).requires_grad_() for v in (x, a))
    y, final = _ssd_chunked(xt, at, torch.from_numpy(Bm), torch.from_numpy(Cm), chunk=128)
    ((y ** 2).sum() + final.sum()).backward()
    jy, _ = _ssd_xla(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm), jnp.asarray(Cm),
                     jnp.asarray(s0), chunk=128)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    assert torch.isfinite(xt.grad).all() and torch.isfinite(at.grad).all()
    ref_ok = bool(jnp.isfinite(jgx).all() and jnp.isfinite(jga).all())
    assert ref_ok == ref_finite
    if ref_ok:
        # d/dx is linear in the decays; d/da sums terms of up to ~500 that
        # cancel, so its fp32 rounding is held by the parameter gradients
        # of test_loss_and_every_gradient_match_jax instead.
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
