"""Serving launcher: prefill + batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --batch 8 --prompt-len 1024 --gen 32 --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu

Requests are served in batch waves: prefill fills the cache for the whole
batch (every attention layer in the flash kernel on the card; the SSM
layers' states and conv windows; the VLM's and enc-dec's waves also draw
their modality memory, which the prefill puts in the cache, encoded for
the enc-dec), then ``decode_step`` emits one greedy token per sequence
per step.  When a wave finishes, the next wave's prompts get a fresh
cache.  Parameters are
drawn from ``torch.Generator(seed)`` on the serving device and the prompts
from ``np.random.default_rng(seed)``, as the JAX launcher draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.relation import resolve_device
from repro_torch.models import zoo
from repro_torch.train import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: zoo.Model, params, *, batch: int, prompt_len: int,
          gen: int, requests: int, seed: int, device,
          keep_rows: int = 0, log=print) -> list[dict]:
    """Serve ``requests`` random prompts in waves of ``batch``.

    Returns one dict per wave: ``prefill_s`` and ``decode_s`` (host clock,
    each ending in a device synchronise), ``prompts`` [batch, prompt_len],
    ``memory`` (the VLM's or enc-dec's f32 [batch, n_frontend_tokens,
    d_model], drawn right after the prompts as the JAX launcher draws it;
    else None)
    and ``tokens`` [batch, gen + 1] (the token greedy decoding picked after
    the prefill, then one per decode step), and with ``keep_rows`` > 0 the
    served f32 ``logits`` [keep_rows, gen + 1, V] of the first rows (the
    prefill's last position, then each decode step's)."""
    cfg = model.config
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    max_len = prompt_len + gen
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    waves = []
    for wave in range(-(-requests // batch)):
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(batch, prompt_len)).astype(np.int32)
        memory = (rng.normal(0, 1, size=(batch, cfg.n_frontend_tokens,
                                         cfg.d_model)).astype(np.float32)
                  if model.needs_memory else None)
        cache = model.init_cache(batch, max_len, device=device)
        mem = None if memory is None else torch.from_numpy(memory).to(device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, torch.from_numpy(prompts).to(device),
                                cache, mem)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(device)
        t1 = time.perf_counter()
        toks, kept = [tok], []
        if keep_rows:
            kept.append(logits[:keep_rows, 0].clone())
        for _ in range(gen):
            tok, logits, cache = decode(params, cache, tok)
            toks.append(tok)
            if keep_rows:
                kept.append(logits[:keep_rows, 0].clone())
        _sync(device)
        t2 = time.perf_counter()
        tokens = torch.cat(toks, dim=1).cpu().numpy()
        rec = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
               "prompts": prompts, "tokens": tokens, "memory": memory}
        if keep_rows:
            rec["logits"] = torch.stack(kept, dim=1)
        waves.append(rec)
        log(f"wave {wave}: served {batch} requests ({gen} tokens each); "
            f"sample: {tokens[0, 1:9].tolist()}")
    return waves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = zoo.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))

    t0 = time.perf_counter()
    waves = serve(model, params, batch=args.batch, prompt_len=args.prompt_len,
                  gen=args.gen, requests=args.requests, seed=args.seed,
                  device=device)
    dt = time.perf_counter() - t0
    total_steps = args.gen * len(waves)
    print(f"served {min(args.batch * len(waves), args.requests)} requests, "
          f"{total_steps} decode steps in {dt:.2f}s "
          f"({args.batch * total_steps / dt:.1f} tok/s)")
    return waves


if __name__ == "__main__":
    main()
