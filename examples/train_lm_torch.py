"""End-to-end training driver on the PyTorch/CUDA port: train a
qwen2-family model for a few hundred steps with checkpoint/restart,
straggler monitoring, and microbatch gradient accumulation.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
        [--d-model 256] [--device cpu]

The port's counterpart of ``examples/train_lm.py`` (same arguments and
flow; runs on the card unless ``--device cpu``).  The default is a ~20M
config (--full-100m selects the ~100M layout; same code path).  Loss is
expected to fall from ~ln(V) as the model memorizes the synthetic stream.
A mid-run simulated crash + resume demonstrates the fault-tolerance path
(disable with --no-crash).  Parameters come from ``torch.Generator(0)``
on the training device, so the losses are not the JAX example's (its
parameters come from ``jax.random``); the steps, checkpoints and restart
are.
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.relation import resolve_device  # noqa: E402
from repro_torch.data.synthetic import TokenGenConfig, batch_at  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import RestartableLoop  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402


def small_cfg(d_model: int, n_layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name=f"qwen2-train-demo-{d_model}", family="dense",
        n_layers=n_layers, d_model=d_model, n_heads=max(d_model // 64, 2),
        n_kv_heads=max(d_model // 128, 1), d_ff=d_model * 4,
        vocab_size=vocab, qkv_bias=True, tie_embeddings=True,
        remat=False, accum_steps=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-100m", action="store_true",
                    help="d_model=768, 12 layers, 32k vocab (~100M params)")
    ap.add_argument("--no-crash", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full_100m:
        cfg = small_cfg(768, 12, 32768)
    else:
        cfg = small_cfg(args.d_model, args.layers, args.vocab)
    model = zoo.build(cfg)
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"accum_steps={cfg.accum_steps}")

    gen = TokenGenConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq, seed=0)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 10))
    step_fn = make_train_step(model, opt)

    def batch_for(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in batch_at(gen, step).items()}

    def fresh_state():
        return init_train_state(
            model, torch.Generator(device=device).manual_seed(0))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    manager = CheckpointManager(ckpt_dir, every=50, keep=2)
    loop = RestartableLoop(manager)

    def metrics_cb(step, metrics, stats):
        if step % 20 == 0:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"dt {stats.last:.2f}s", flush=True)

    # the step updates its state in place: measure the first loss on a
    # state of its own, then start again from the seed
    first_loss = float(step_fn(fresh_state(), batch_for(0))[1]["loss"])
    state = fresh_state()

    crash_at = None if args.no_crash else min(args.steps // 2, 120)
    try:
        state, end = loop.run(state, step_fn, batch_for, args.steps,
                              fail_at=crash_at, metrics_cb=metrics_cb)
    except RuntimeError as e:
        print(f"!! {e} — restarting from the newest committed checkpoint")
        resumed, start = loop.resume_step(fresh_state(), device=device)
        state, end = loop.run(resumed, step_fn, batch_for, args.steps,
                              start_step=start, metrics_cb=metrics_cb)

    final_loss = float(
        make_train_step(model, opt)(state, batch_for(end))[1]["loss"])
    print(f"\ndone @ step {end}: loss {first_loss:.3f} -> "
          f"{final_loss:.3f} (ckpts in {ckpt_dir})")
    assert final_loss < first_loss, "training did not reduce loss"
    return first_loss, final_loss


if __name__ == "__main__":
    main()
