"""The port's data plane against the JAX package's: RPK1 packing, the
``ShardedSnapshotLoader`` batch stream and its resume, and ``DeviceFeed`` on
the CPU.

The loader is hash-ordered, so its stream must equal the live reference's bit
for bit.  Both loaders read one checkout plan of a packed corpus with small
manifest pages (so page-window mode has windows to permute), in ``global``
and ``page_window`` modes, across a mid-epoch ``state``/``restore`` (each
package restoring the other's state) and an epoch boundary.  No digest is
pinned: the reference's loader goldens show that a pinned digest depends on
the environment.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import components as jax_components  # noqa: E402
from repro.data.loader import ShardedSnapshotLoader as JaxLoader  # noqa: E402
from repro_torch.core import Pipeline, Workflow  # noqa: E402
from repro_torch.data import (DeviceFeed, PackComponent,  # noqa: E402
                              ShardedSnapshotLoader, SplitComponent,
                              TokenizeComponent, components)
from repro_torch.launch.train import synthetic_corpus  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402

BATCH, SEQ = 4, 32


@pytest.fixture(scope="module")
def plan():
    """A packed corpus (~100 packs) behind pages of 8 records."""
    plat = Platform.open(actor="trainer", page_size=8)
    plat.dataset("corpus/raw").check_in(synthetic_corpus(24), actor="ingest")
    plat.register(Workflow(
        name="tokenize-pack",
        pipeline=Pipeline([SplitComponent(eval_fraction=0.0), TokenizeComponent(),
                           PackComponent(seq_len=SEQ)], name="tok-pack"),
        input_dataset="corpus/raw", output_dataset="corpus/packed", n_shards=2))
    assert plat.run("tokenize-pack").state == "SUCCEEDED"
    plan = plat.dataset("corpus/packed").plan()
    assert plan.page_count() > 4
    return plan


def test_packed_bytes_are_bit_identical():
    rng = np.random.default_rng(0)
    tokens, segments, positions = (rng.integers(-1, 300, 65).astype(np.int32)
                                   for _ in range(3))
    got = components.encode_packed(tokens, segments, positions)
    assert got == jax_components.encode_packed(tokens, segments, positions)
    for a, b in zip(components.decode_packed(got),
                    jax_components.decode_packed(got)):
        np.testing.assert_array_equal(a, b)


def _stream(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("mode", ["global", "page_window"])
def test_batch_stream_and_resume_equal_the_reference(plan, mode):
    kw = dict(shuffle=mode, window_pages=2, seed=3)
    ref, port = JaxLoader(plan, BATCH, SEQ, **kw), ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    per_epoch = port._per_epoch()
    n = per_epoch + 5                       # across the epoch boundary
    want = _stream(ref, n)
    _assert_same(_stream(port, n), want)
    assert port.state() == ref.state()
    if mode == "page_window":      # how often a window reloads depends on the
        # decode workers' timing, so the counts are not compared
        assert port.stats()["pages_streamed"] > 0 and ref.stats()["pages_streamed"] > 0

    # mid-epoch resume, each package from the other's state
    k = per_epoch // 2
    ref_mid, port_mid = JaxLoader(plan, BATCH, SEQ, **kw), ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    _stream(ref_mid, k)
    _stream(port_mid, k)
    assert port_mid.state() == ref_mid.state()
    resumed = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    resumed.restore(ref_mid.state())
    _assert_same(_stream(resumed, n - k), want[k:])
    back = JaxLoader(plan, BATCH, SEQ, **kw)
    back.restore(port_mid.state())
    _assert_same(_stream(back, n - k), want[k:])
    # next_batch (no worker pool) walks the same stream
    single = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    _assert_same([single.next_batch() for _ in range(3)], want[:3])


def test_restore_refuses_a_different_mode(plan):
    state = ShardedSnapshotLoader(plan, BATCH, SEQ, shuffle="global").state()
    with pytest.raises(ValueError, match="shuffle modes"):
        ShardedSnapshotLoader(plan, BATCH, SEQ, shuffle="page_window").restore(state)


def test_device_feed_on_cpu_yields_the_stream_with_paired_states(plan):
    kw = dict(shuffle="page_window", window_pages=2)
    want = _stream(ShardedSnapshotLoader(plan, BATCH, SEQ, **kw), 6)
    loader = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    feed = DeviceFeed(loader, device="cpu")
    it = iter(feed)
    got = [next(it) for _ in range(6)]
    it.close()
    for i, ((batch, state), host) in enumerate(zip(got, want)):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in batch.values())
        for k in host:
            np.testing.assert_array_equal(batch[k].numpy(), host[k])
        assert state["step"] == i + 1     # the state right after this batch
        if i == 2:                        # it resumes onto the next batch
            resumed = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
            resumed.restore(state)
            _assert_same([resumed.next_batch()], [want[3]])
    assert feed.stats()["transfers"] >= 6


def test_device_feed_refuses_a_missing_gpu(plan):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeed(ShardedSnapshotLoader(plan, BATCH, SEQ), device="cuda")


def test_wait_fraction_counts_the_consumers_time(plan):
    """``wait_fraction`` is the share of the consumer's wall time spent
    blocked on the loader: a consumer that works 50 ms a batch while the
    decode workers keep up waits for almost none of it.  (The reference's
    clock skips the consumer's time, so its run time stays near 0.)"""
    loader = ShardedSnapshotLoader(plan, BATCH, SEQ)
    it = iter(loader)
    for _ in range(6):
        next(it)
        time.sleep(0.05)
    it.close()
    stats = loader.stats()
    assert stats["run_time_s"] >= 5 * 0.05
    assert stats["wait_fraction"] < 0.2
    ref = JaxLoader(plan, BATCH, SEQ)
    it = iter(ref)
    for _ in range(6):
        next(it)
        time.sleep(0.05)
    it.close()
    assert ref.stats()["run_time_s"] < 0.05
