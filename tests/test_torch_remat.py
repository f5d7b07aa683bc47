"""``RuntimeConfig.remat="dots"``: the reference's
``checkpoint_dots_with_no_batch_dims`` as selective activation
checkpointing (``models/decoder.py::remat_call``).

The loss and every gradient under ``"dots"`` equal those under ``"none"``
and ``"full"`` (fp32, 3e-4, tests/test_kernels.py::_tol) and, for one
decoder and the encoder-decoder, ``jax.grad`` of the reference's loss.  A
``TorchDispatchMode`` counts the matrix products each backward pass runs:
under ``"dots"`` it recomputes no forward ``aten.mm`` (the backward runs as
many as without remat) but does recompute the forward's ``aten.bmm``; under
``"full"`` it runs the forward ``aten.mm`` of the layers again (up to the
last one whose output a backward needs).
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402
from test_torch_train_loss import packed_batch  # noqa: E402

TOL = dict(atol=3e-4, rtol=3e-4)
RT = dict(compute_dtype=torch.float32, attn_impl="ref", ssd_impl="chunked",
          rglru_impl="scan")
JAX_RT = dict(compute_dtype=jnp.float32, attn_impl="naive", ssd_impl="xla",
              rglru_impl="xla")
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
BMM = (torch.ops.aten.bmm.default,)
ARCHS = ["gemma2-9b", "mamba2-1.3b", "mixtral-8x22b", "seamless-m4t-medium"]


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))

    def total(self, ops):
        return sum(self.counts[op] for op in ops)


def _batch(cfg, seed):
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(seed)
        tokens = rng.integers(3, cfg.vocab_size, size=(2, 17)).astype(np.int32)
        return {"frontend_embeds": rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32),
                "tokens": tokens[:, :16], "labels": tokens[:, 1:]}
    return packed_batch(seed, 2, 32)


def _model(arch, remat, seed=1):
    cfg = get_smoke_config(arch)
    extra = {"moe_group_size": 16} if cfg.n_experts else {}
    return build_model(cfg, RuntimeConfig(**RT, remat=remat, **extra), device="cpu",
                       seed=seed)


def _loss_and_grads(model, batch):
    """(loss, grads, mm and bmm counts of the forward pass, of the backward)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = dict(model.named_parameters())
    with CountOps() as fwd:
        loss, _ = model.loss(tb)
    with CountOps() as bwd:
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), fwd, bwd


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gives_the_loss_and_gradients_of_none_and_full(arch):
    batch = _batch(get_smoke_config(arch), 3)
    plain = _model(arch, "none")
    out = {}
    for remat in ("none", "full", "dots"):
        model = _model(arch, remat)
        model.load_state_dict(plain.state_dict())
        out[remat] = _loss_and_grads(model, batch)
    loss0, grads0 = out["none"][:2]
    for remat in ("full", "dots"):
        loss, grads = out[remat][:2]
        np.testing.assert_allclose(loss.item(), loss0.item(), **TOL)
        for name, g in grads0.items():
            np.testing.assert_allclose(grads[name].numpy(), g.numpy(), **TOL,
                                       err_msg=f"{remat} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_the_matrix_products_and_recomputes_the_rest(arch):
    batch = _batch(get_smoke_config(arch), 4)
    counts = {remat: _loss_and_grads(_model(arch, remat), batch)[2:]
              for remat in ("none", "full", "dots")}
    fwd_none, bwd_none = counts["none"]
    _, bwd_dots = counts["dots"]
    _, bwd_full = counts["full"]
    # The forward's mm outside the recomputed layers: the logits' head.  A
    # layer's recomputation stops once it has rebuilt every saved tensor, so
    # "full" may skip a last product whose output nothing saves (mamba2's
    # out_proj, seamless's mlp wo).
    head = 1
    assert bwd_dots.total(MM) == bwd_none.total(MM)
    assert bwd_none.total(MM) < bwd_full.total(MM) <= (
        bwd_none.total(MM) + fwd_none.total(MM) - head)
    if fwd_none.total(BMM):
        assert bwd_dots.total(BMM) > bwd_none.total(BMM)
        assert bwd_dots.total(BMM) == bwd_full.total(BMM)


@pytest.mark.parametrize("arch", ["gemma2-9b", "seamless-m4t-medium"])
def test_dots_matches_jax_grad_of_the_reference(arch):
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg, JaxRuntimeConfig(**JAX_RT, remat="dots"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = _model(arch, "dots")
    model.load_jax_params(jax.tree.map(np.asarray, jparams))
    batch = _batch(jcfg, 5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads, _, _ = _loss_and_grads(model, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    got = params_to_jax(grads, len(model.pattern))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
