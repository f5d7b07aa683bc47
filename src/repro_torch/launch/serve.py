"""Batched serving driver: build a model, prefill a batch of prompts, decode.

Port of ``repro.launch.serve``, for every family the port builds (mamba2,
recurrentgemma, the attention-only stablelm, qwen2.5, gemma2, gemma3 and
internvl2, whose frontend stub is left out as ``repro.launch.serve`` leaves
it, the MoE mixtral and arctic, and the encoder-decoder seamless, which, as
in the reference, encodes (batch, prompt_len, d_model) seeded frames x 0.1
and prefills the decoder with the first prompt token alone).  Runs on the CUDA card unless ``--device cpu``
is given; prefill's SSD and RG-LRU scans and attention then launch the
hand-written Hopper kernels.  The KV cache holds ``prompt_len + gen``
positions (a window-sized ring for windowed layers), as the reference sets
``max_cache_len``.

The compute dtype defaults to float32, as in ``repro.launch.serve``: on the
card that routes attention and SSD to their fp32 kernels (``flash_fwd``,
``ssd_fwd``), not the tensor-core ones the serving path takes under
``--dtype bfloat16``.  So before its timings this command prints how many
times each kernel route launched, which names the kernels a time measured.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --smoke --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
        --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..kernels import launch_counts
from ..models import RuntimeConfig, build_model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32",
                    help="compute dtype (params stay float32)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rt = RuntimeConfig(compute_dtype=_DTYPES[args.dtype],
                       max_cache_len=args.prompt_len + args.gen)
    model = build_model(cfg, rt, device=args.device, seed=0)
    device = model.device

    B = args.batch
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(3, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=device)

    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.randn((B, args.prompt_len, cfg.d_model), generator=gen,
                             device=device) * 0.1

    before = launch_counts()
    t0 = time.perf_counter()
    if frames is not None:
        logits, cache, pos = model.prefill(frames, prompts[:, :1])
    else:
        logits, cache, pos = model.prefill(prompts)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    generated = []
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    t1 = time.perf_counter()
    for i in range(args.gen):
        generated.append(tok)
        logits, cache = model.decode_step(cache, tok, pos + i)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1, :] / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    _sync(device)
    decode_s = time.perf_counter() - t1

    toks = torch.cat(generated, dim=1).cpu().numpy()
    tput = B * args.gen / max(decode_s, 1e-9)
    launches = {name: n - before[name] for name, n in launch_counts().items()}
    print(f"arch={cfg.name} device={device} batch={B} "
          f"prompt={args.prompt_len} gen={args.gen} dtype={args.dtype}")
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    print(f"prefill: {prefill_s*1e3:.1f} ms   decode: {decode_s*1e3:.1f} ms "
          f"({tput:.1f} tok/s incl. first-call kernel build)")
    print("sample token ids:", toks[0][:12].tolist())
    return {"tokens": toks, "prefill_s": prefill_s, "decode_s": decode_s,
            "tok_per_s": tput, "launches": launches}


if __name__ == "__main__":
    main()
