"""Train a softmax-1 decoder with the port's sharded TP x DP (x SP) train
step.

The PyTorch port's counterpart of ``examples/train.py``: Megatron-sharded
weights over 'model', the batch over 'data', and optionally ring-attention
sequence parallelism over 'sp'. It runs as one process a rank
(``torch.multiprocessing``, spawned), each joining one
``torch.distributed`` group through a file rendezvous: NCCL on the cards,
one rank a card; gloo with ``--cpu``, ``--world`` ranks (default 2)::

    python examples/torch_train.py                       # every card
    python examples/torch_train.py --cpu --world 4 --sp  # 4 CPU ranks

Without a card and without ``--cpu`` it raises.
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch


def _axes(args, world):
    """JAX's layout: TP over half the ranks (or --model-parallel), SP 2
    under --sp, the rest over 'data'."""
    sp = 2 if args["sp"] else 1
    tp = args["model_parallel"] or max(1, world // (2 * sp))
    if tp * sp > world or world % (tp * sp):
        raise ValueError(f"{world} ranks do not split into model_parallel={tp}"
                         f"{' x sp=2' if args['sp'] else ''}")
    axes = {"data": world // (tp * sp), "model": tp}
    if args["sp"]:
        axes["sp"] = sp
    return axes


def _rank(rank, world, directory, args):
    """One rank's training run; rank 0 prints and writes the losses."""
    from flash_attention_softmax_n_tpu_torch.models import (
        DecoderConfig,
        init_decoder_params,
    )
    from flash_attention_softmax_n_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_train_step,
    )

    torch.set_num_threads(1)
    device = "cpu" if args["cpu"] else None
    initialize_distributed(f"file://{directory}/rendezvous", world, rank, device=device)
    try:
        axes = _axes(args, world)
        mesh = make_mesh(axes)
        dev = torch.device("cpu") if args["cpu"] else torch.device(
            "cuda", torch.cuda.current_device())
        if rank == 0:
            print(f"mesh: {axes} on {dev.type} ({world} ranks)")
        cfg = DecoderConfig(
            vocab_size=1024, d_model=256, n_layers=4, n_heads=8, n_kv_heads=8,
            d_ff=704, max_seq_len=args["seq"], softmax_n=1.0,
            dtype=torch.float32 if args["cpu"] else torch.bfloat16,
            attn_implementation="xla" if args["cpu"] else "auto",
        )
        params = init_decoder_params(cfg, 0, device=dev)
        init, step = make_train_step(cfg, mesh, learning_rate=3e-4,
                                     sp_axis="sp" if args["sp"] else None)
        params, opt_state = init(params)
        gen = torch.Generator(device=dev).manual_seed(1)  # alike on every rank
        losses = []
        for i in range(args["steps"]):
            tokens = torch.randint(0, cfg.vocab_size, (args["batch"], args["seq"]),
                                   generator=gen, device=dev)
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, tokens)
            losses.append(float(loss))
            if rank == 0:
                print(f"step {i}: loss={losses[-1]:.4f} ({time.perf_counter() - t0:.2f}s)")
        if rank == 0:
            (pathlib.Path(directory) / "losses.json").write_text(json.dumps(losses))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU, the kernels' plain versions")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks (default: every card; 2 with --cpu)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="TP degree (default: half the ranks)")
    ap.add_argument("--sp", action="store_true",
                    help="add a 2-way sequence-parallel (ring attention) axis")
    args = vars(ap.parse_args(argv))

    from flash_attention_softmax_n_tpu_torch._device import resolve_device

    resolve_device("cpu" if args["cpu"] else None)
    world = args["world"] or (2 if args["cpu"] else torch.cuda.device_count())
    _axes(args, world)  # refuse a layout before starting any rank
    with tempfile.TemporaryDirectory() as directory:
        if world == 1:
            _rank(0, 1, directory, args)
        else:
            import torch.multiprocessing as mp
            mp.start_processes(_rank, args=(world, directory, args), nprocs=world,
                               join=True, start_method="spawn")
        return json.loads((pathlib.Path(directory) / "losses.json").read_text())


if __name__ == "__main__":
    main()
