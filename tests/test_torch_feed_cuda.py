"""``DeviceFeed`` on the card: pinned host buffers, copies on a side stream.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no
JAX, so it also runs on a card machine that has none:

    python -m pytest -q -m cuda tests/test_torch_feed_cuda.py

The feed must hand out the loader's stream unchanged, on the card, each batch
with the loader state taken right after it, while its ring of pinned buffers
is refilled many times over and the consumer's stream keeps the card busy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Pipeline, Workflow  # noqa: E402
from repro_torch.data import (DeviceFeed, PackComponent,  # noqa: E402
                              ShardedSnapshotLoader, SplitComponent,
                              TokenizeComponent)
from repro_torch.launch.train import synthetic_corpus  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402

pytestmark = pytest.mark.cuda
BATCH, SEQ = 4, 64


@pytest.fixture(scope="module")
def plan():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: DeviceFeed's CUDA path")
    plat = Platform.open(actor="trainer", page_size=16)
    plat.dataset("corpus/raw").check_in(synthetic_corpus(64), actor="ingest")
    plat.register(Workflow(
        name="tokenize-pack",
        pipeline=Pipeline([SplitComponent(eval_fraction=0.0), TokenizeComponent(),
                           PackComponent(seq_len=SEQ)], name="tok-pack"),
        input_dataset="corpus/raw", output_dataset="corpus/packed", n_shards=2))
    assert plat.run("tokenize-pack").state == "SUCCEEDED"
    return plat.dataset("corpus/packed").plan()


@pytest.mark.parametrize("depth", [1, 2])
def test_device_feed_hands_out_the_host_stream_on_the_card(plan, depth):
    kw = dict(shuffle="page_window", window_pages=2)
    n = 24
    host = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    want = [host.next_batch() for _ in range(n)]
    loader = ShardedSnapshotLoader(plan, BATCH, SEQ, **kw)
    feed = DeviceFeed(loader, device="cuda", depth=depth)
    it = iter(feed)
    busy = torch.randn(2048, 2048, device="cuda")
    for i in range(n):
        batch, state = next(it)
        for _ in range(4):              # keep the consumer's stream busy
            busy = torch.tanh(busy @ busy * 1e-3)
        got = {k: v.cpu().numpy() for k, v in batch.items()}
        assert all(v.is_cuda for v in batch.values())
        assert state["step"] == i + 1
        for k in want[i]:
            np.testing.assert_array_equal(got[k], want[i][k], err_msg=f"batch {i} {k}")
    it.close()
    assert feed.stats()["transfers"] >= n
