"""Serving example on the PyTorch/CUDA port: batched prefill + greedy
decode for each LM family at its reduced config, including a long-context
SSM serve with O(1) per-token state.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

The port's counterpart of ``examples/serve_lm.py`` (same configs, prompts
and flow; runs on the card unless ``--device cpu``).  Parameters come from
``torch.Generator(0)`` on the serving device, so the sampled tokens are
not the JAX example's (its parameters come from ``jax.random``); the
prompts and memory are (``np.random.default_rng(0)``).
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.relation import resolve_device  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, device, batch=2, prompt_len=24, gen=12):
    cfg = configs.smoke(arch)
    model = zoo.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(batch, prompt_len)).astype(np.int32)
    memory = None
    if model.needs_memory and cfg.n_frontend_tokens:
        memory = torch.from_numpy(rng.normal(0, 1, size=(
            batch, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)).to(device)

    cache = model.init_cache(batch, prompt_len + gen, device=device)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    _sync(device)
    t0 = time.time()
    logits, cache = prefill(params, torch.from_numpy(prompts).to(device),
                            cache, memory)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    toks = []
    for _ in range(gen):
        tok, logits, cache = decode(params, cache, tok)
        toks.append(tok)
    outs = torch.cat(toks, dim=1).cpu().tolist()
    dt = time.time() - t0
    print(f"{arch:22s} prefill {prompt_len} + decode {gen}: "
          f"{batch * gen / dt:6.1f} tok/s   sample: {outs[0][:6]}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("== dense / MoE / VLM / enc-dec serving (reduced configs) ==")
    serve("qwen2-1.5b", device)
    serve("qwen3-moe-30b-a3b", device)
    serve("llama-3.2-vision-11b", device)
    serve("seamless-m4t-medium", device)
    print("\n== long-context SSM serving (bounded state) ==")
    serve("mamba2-370m", device, prompt_len=48, gen=16)
    serve("zamba2-1.2b", device, prompt_len=48, gen=16)
    print("\nserve_lm OK")


if __name__ == "__main__":
    main()
