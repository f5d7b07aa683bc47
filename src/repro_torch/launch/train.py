"""End-to-end training driver: the port's platform feeding a torch trainer.

Port of ``repro.launch.train``.  Flow (exactly Fig. 1 of the disclosure):
  1. raw text is checked into the dataset manager (pipeline A),
  2. a registered workflow (tokenize -> pack) produces the training
     snapshot (pipeline X),
  3. the trainer streams the snapshot through the loader and
     :class:`~repro_torch.data.DeviceFeed` and trains with AdamW,
  4. checkpoints are checked back in as dataset versions with lineage
     (snapshot -> train run -> checkpoint), so revoking a raw record
     reports the checkpoints that transitively ingested it.

Fault tolerance: training resumes exactly from (checkpoint, loader state);
``--kill-at`` drops the model, optimizer state and loader in this process
after N steps, rebuilds them and restores from the platform checkpoint, and
the remaining steps repeat the uninterrupted run's bit for bit.  For that
the driver turns on ``torch.use_deterministic_algorithms`` (and sets
``CUBLAS_WORKSPACE_CONFIG``, which cuBLAS reads when CUDA starts, unless the
caller set it) and keeps TF32 off, for the run.

As the reference's driver, it trains through the plain paths at fp32
compute (``attn_impl="ref"``, the reference's ``"naive"``;
``ssd_impl="chunked"``, its ``"xla"``; ``rglru_impl="scan"``, its
``"xla"``): no kernel has a backward pass.  It runs on the CUDA card unless
``--device cpu`` is given.

Data parallelism, as the reference driver's ``ShardingRules(mesh,
batch_axes=("data",), fsdp_axis=None, tp_axis=None)``: the ranks of the
process group form a 1-D "data" mesh; every rank reads the same global
batch, the feed hands each its rows (``batch_specs``), and the train step
sums the gradients over "data" before the clip, so each step equals the
one-process step on the global batch.  Under ``torchrun`` the group comes
from its environment (NCCL on the card, gloo with ``--device cpu``);
without it the driver makes a one-rank group on a ``FileStore`` in a
temporary directory (no network port) and computes what one process does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 10 --batch 4 --seq-len 64
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --smoke --device cpu --steps 10 --batch 4 --seq-len 64
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..core import Pipeline, Record, Workflow
from ..core.lineage import NodeKind
from ..data import (DeviceFeed, PackComponent, ShardedSnapshotLoader,
                    SplitComponent, TokenizeComponent)
from ..models import RuntimeConfig, build_model
from ..models.common import resolve_device
from ..platform import Platform
from ..train import (TrainConfig, load_checkpoint, make_train_step,
                     save_checkpoint)
from ..train.checkpoint import checkpoint_node_id
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.sharding import (ActivationSharding, ShardingRules, batch_specs,
                              named)
from .mesh import make_local_mesh


# The reference driver's runtime (fp32 compute through the plain paths),
# under the port's impl names.
TRAIN_RUNTIME = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
                     attn_impl="ref", ssd_impl="chunked", rglru_impl="scan")


def synthetic_corpus(n_docs: int = 256, seed: int = 0):
    """Deterministic synthetic text corpus (no network in this container)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:03d}" for i in range(100)]
    docs = []
    for i in range(n_docs):
        n = int(rng.integers(20, 200))
        text = " ".join(rng.choice(words, size=n))
        docs.append(Record(f"doc-{i:05d}", text.encode(), {"lang": "en"}))
    return docs


def build_platform(seq_len: int, n_docs: int = 256):
    """Stand up the platform and run the Fig. 1 pipelines."""
    plat = Platform.open(actor="trainer")
    plat.dataset("corpus/raw").check_in(
        synthetic_corpus(n_docs), actor="ingest",
        message="pipeline A: ingest")
    plat.register(Workflow(
        name="tokenize-pack",
        pipeline=Pipeline([SplitComponent(eval_fraction=0.0),
                           TokenizeComponent(),
                           PackComponent(seq_len=seq_len)], name="tok-pack"),
        input_dataset="corpus/raw",
        output_dataset="corpus/packed",
        n_shards=2,
    ))
    run = plat.run("tokenize-pack")
    assert run.state == "SUCCEEDED", run.error
    return plat, run


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels and no TF32 for the block, restored after it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


@contextlib.contextmanager
def process_group(device: torch.device):
    """The default process group for the run: the caller's if one is up,
    torchrun's (from its environment) if it launched us, else a one-rank
    group on a FileStore in a temporary directory.  A group made here is
    destroyed after the block."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with contextlib.ExitStack() as stack:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="train-pg-"))
            dist.init_process_group(backend, store=dist.FileStore(
                os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="simulate a crash after N steps, then restart "
                         "from the platform checkpoint")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--shuffle", default="auto",
                    choices=["auto", "global", "page_window"],
                    help="loader shuffle mode (auto: page-window streaming "
                         "above the size threshold, else legacy global)")
    ap.add_argument("--window-pages", type=int, default=8,
                    help="page-window shuffle width (pages per window)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with deterministic(), process_group(device):
        return _train(args, device)


def _train(args, device: torch.device) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    period = len(cfg.pattern)
    mesh = make_local_mesh(device.type)
    rules = ShardingRules(mesh, batch_axes=("data",), fsdp_axis=None, tp_axis=None)
    rt = RuntimeConfig(**TRAIN_RUNTIME, act_sharding=ActivationSharding(rules))
    lead = dist.get_rank() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg)

    plat, wf_run = build_platform(args.seq_len, n_docs=max(
        args.batch * 8, 128))
    dm = plat.manager
    snap = plat.dataset("corpus/packed").checkout()
    say(f"platform: snapshot {snap.snapshot_id} with {len(snap)} packs")

    def make_loader():
        # The loader feeds from the lazy plan (page-granular read surface;
        # the registered snapshot above carries lineage).
        return ShardedSnapshotLoader(
            plat.dataset("corpus/packed").plan(), args.batch, args.seq_len,
            shuffle=args.shuffle, window_pages=args.window_pages)

    train_cfg = TrainConfig(optimizer=OptimizerConfig(
        name="adamw", lr=args.lr, warmup_steps=10, total_steps=args.steps))
    opt = make_optimizer(train_cfg.optimizer, period=period)

    def batch_shardings(host_batch):
        return named(mesh, batch_specs(host_batch, rules))

    def make_trainer():
        model = build_model(cfg, rt, device=device, seed=0)
        return model, dict(model.named_parameters()), make_train_step(model, train_cfg)

    model, params, step_fn = make_trainer()
    opt_state = opt.init(params)
    loader = make_loader()
    run_node = f"train_run:{int(time.time())}"
    dm.lineage.add_node(run_node, NodeKind.WORKFLOW_RUN, kind_detail="train",
                        arch=cfg.name)
    dm.lineage.add_edge(snap.snapshot_id, run_node, "input_to")
    dm.lineage.flush()

    losses, step_s, save_s = [], [], []
    load_s = None
    step = 0

    saved = {}                        # step -> commit of its checkpoint

    def checkpoint(loader_state) -> str:
        t0 = time.perf_counter()
        cid = save_checkpoint(
            dm, f"checkpoints/{cfg.name}", step, params, opt_state,
            extra={"loader": loader_state}, data_snapshot_id=snap.snapshot_id,
            run_node=run_node, period=period)
        save_s.append(time.perf_counter() - t0)
        saved[step] = cid
        return cid

    def do_train(until: int):
        """Drive the step loop from the double-buffered device feed: the
        next batch's host decode AND device transfer overlap the current
        train_step, and each yielded batch carries the loader state that
        makes its checkpoint bit-exact to resume.  A step's time runs from
        asking for its batch to its loss on the host."""
        nonlocal params, opt_state, step
        if step >= until:
            return
        feed_it = iter(DeviceFeed(loader, device, sharding_fn=batch_shardings))
        try:
            while step < until:
                t0 = time.perf_counter()
                batch, loader_state = next(feed_it)
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                step += 1
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t0)
                if step % args.log_every == 0 or step == until:
                    say(f"step {step:5d} loss {losses[-1]:.4f}")
                if step % args.checkpoint_every == 0:
                    cid = checkpoint(loader_state)
                    say(f"  checkpointed step {step} -> version {cid[:12]}")
        finally:
            feed_it.close()   # stop decode workers; buffered batches drop

    if args.kill_at and args.kill_at < args.steps:
        do_train(args.kill_at)
        say(f"--- simulated crash at step {step}; restarting ---")
        # Restart path: drop the process's training state, rebuild it and
        # restore from the platform.
        del model, params, opt_state, step_fn, loader
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model, params, step_fn = make_trainer()
        like_opt = opt.init(params)
        restored, opt_state, extra = load_checkpoint(
            dm, f"checkpoints/{cfg.name}", params, like_opt, period=period)
        del like_opt
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored[name])
        del restored
        loader = make_loader()
        loader.restore(extra["loader"])
        step = int(opt_state["step"])      # waits for the copies above
        load_s = time.perf_counter() - t0
        say(f"restored at step {step}, loader {extra['loader']}")

    do_train(args.steps)

    # The last step's periodic checkpoint, where there is one, is the final
    # one (the same params and state; its loader state is the batch's).
    cid = saved.get(step) or checkpoint(loader.state())
    say(f"final checkpoint -> {cid[:12]}")
    ld_stats = loader.stats()
    say(f"loader: mode={ld_stats['mode']} "
        f"wait_fraction={ld_stats['wait_fraction']:.3f} "
        f"pages_streamed={int(ld_stats['pages_streamed'])} "
        f"peak_resident_ids={int(ld_stats['peak_resident_ids'])}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"loss: first5={first:.4f} last5={last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    # lineage: the checkpoint's provenance reaches the raw corpus
    anc = dm.lineage.ancestors(checkpoint_node_id(f"checkpoints/{cfg.name}",
                                                  step))
    say(f"lineage ancestors of final checkpoint: {len(anc)} node(s)")
    return {"losses": losses, "steps": step, "dm": dm, "platform": plat,
            "checkpoint": cid, "improved": bool(last < first),
            "loader": loader, "loader_stats": ld_stats, "step_s": step_s,
            "ckpt_save_s": save_s, "ckpt_load_s": load_s}


if __name__ == "__main__":
    main()
