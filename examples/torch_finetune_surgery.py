"""Surgery -> fine-tune with the port: the reference's composer workflow.

The PyTorch port's counterpart of ``examples/finetune_surgery.py``:

  1. surgery as a checkpoint rewrite: convert an HF Llama-style model and
     set softmax_n=1 in the config (``surgery.from_pretrained_hf``);
  2. fine-tune with the sharded train step in training mode:
     ``cfg.attn_dropout`` rides the kernels' in-kernel hash dropout on the
     card (the plain versions' with ``--cpu``), drawn from a generator
     seeded per step, on a one-rank TP x DP mesh (NCCL on the card, gloo
     with ``--cpu``; ``examples/torch_train.py`` runs many ranks);
  3. eval-mode generation on the tuned weights.

Offline, as the JAX example: the "pretrained" model is a stand-in built
from a tiny Llama config and a seeded state dict (``utils.standin``), since
the machine with the card has no ``transformers``::

    python examples/torch_finetune_surgery.py
    python examples/torch_finetune_surgery.py --cpu --steps 2
"""

import argparse
import dataclasses
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

# the JAX example's tiny Llama (HF LlamaConfig attributes), head dim 16: on
# the card K1, K5 and K6 run it zero-padded to head dim 32
TINY_LLAMA = dict(model_type="llama", vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  rms_norm_eps=1e-6, rope_theta=10000.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dropout", type=float, default=0.1)
    args = ap.parse_args(argv)

    from flash_attention_softmax_n_tpu_torch._device import resolve_device
    from flash_attention_softmax_n_tpu_torch.models import greedy_generate
    from flash_attention_softmax_n_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_train_step,
    )
    from flash_attention_softmax_n_tpu_torch.surgery import from_pretrained_hf
    from flash_attention_softmax_n_tpu_torch.utils.standin import standin

    dev = resolve_device("cpu" if args.cpu else None)

    # --- 1. "pretrained" model + surgery (checkpoint rewrite, n=1) ---
    hf = standin(dict(TINY_LLAMA, max_position_embeddings=args.seq),
                 torch.Generator(device=dev).manual_seed(0), dev)
    cfg, params = from_pretrained_hf(hf, softmax_n_param=1.0, dtype=torch.float32,
                                     device=dev)
    cfg = dataclasses.replace(cfg, attn_dropout=args.dropout)
    print(f"surgery: softmax_n={cfg.softmax_n}, fine-tune dropout={cfg.attn_dropout}")

    # --- 2. fine-tune, training mode, on a one-rank TP x DP mesh ---
    with tempfile.TemporaryDirectory() as directory:
        initialize_distributed(f"file://{directory}/rendezvous", 1, 0,
                               device="cpu" if args.cpu else None)
        try:
            mesh = make_mesh({"data": 1, "model": 1})
            init, step = make_train_step(cfg, mesh, learning_rate=3e-4)
            params, opt_state = init(params)
            rng = np.random.RandomState(0)
            losses = []
            t0 = time.perf_counter()
            for i in range(args.steps):
                tokens = torch.from_numpy(
                    rng.randint(0, cfg.vocab_size - 1, size=(args.batch, args.seq))).to(dev)
                params, opt_state, loss = step(
                    params, opt_state, tokens,
                    generator=torch.Generator(device=dev).manual_seed(42 + i))
                losses.append(float(loss))
                if i % 5 == 0 or i == args.steps - 1:
                    print(f"step {i:3d} loss {losses[-1]:.4f} "
                          f"({time.perf_counter() - t0:.1f}s)")
        finally:
            torch.distributed.destroy_process_group()

    # --- 3. eval-mode generation on the tuned weights ---
    with torch.no_grad():
        out = greedy_generate(params, cfg, [[1, 17, 42, 9]], max_new_tokens=8, device=dev)
    print("generated:", out[0].tolist())
    print("OK")
    return losses, out[0].tolist()


if __name__ == "__main__":
    main()
