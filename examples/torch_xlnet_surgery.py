"""XLNet softmax-N surgery with the port: the reference's second migration
story.

The reference patches a live HF ``XLNetModel``'s ``rel_attn_core``; here the
same outcome is a checkpoint rewrite: convert the HF weights once, set
``softmax_n`` in the config and run the port's two-stream model
(``models.xlnet``). The PyTorch port's counterpart of
``examples/xlnet_surgery.py``.

By default the XLNet is a stand-in built offline from a tiny config and a
seeded state dict (``utils.standin``): n = 1 against n = 0 shows the
surgery at work, and per-layer attention-output statistics follow.
``--model PATH`` loads a local HF checkpoint instead (needs
``transformers``; nothing is downloaded) and also holds n = 0 against HF's
own forward (the reference's invariant: n = 0 is HF). Runs on the card, or
with ``--cpu`` through the plain versions::

    python examples/torch_xlnet_surgery.py
    python examples/torch_xlnet_surgery.py --cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

# a tiny XLNet (HF XLNetConfig attributes)
TINY_XLNET = dict(model_type="xlnet", vocab_size=128, d_model=32, n_layer=2, n_head=4,
                  d_head=8, d_inner=64, ff_activation="gelu", attn_type="bi",
                  bi_data=False, clamp_len=-1, same_length=False, mem_len=None,
                  reuse_len=None, layer_norm_eps=1e-12, dropout=0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="a local HF XLNet checkpoint (needs transformers); default: "
                         "an offline stand-in of a tiny XLNet")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--n", type=float, default=1.0, help="softmax_n")
    args = ap.parse_args(argv)

    from flash_attention_softmax_n_tpu_torch._device import resolve_device
    from flash_attention_softmax_n_tpu_torch.models.xlnet import xlnet_forward
    from flash_attention_softmax_n_tpu_torch.surgery import from_pretrained_hf
    from flash_attention_softmax_n_tpu_torch.utils.standin import standin

    dev = resolve_device("cpu" if args.cpu else None)
    if args.model:
        import transformers
        hf = transformers.XLNetModel.from_pretrained(args.model, local_files_only=True)
        hf.eval()
    else:
        print("building a stand-in of a tiny XLNet (offline mode)")
        hf = standin(TINY_XLNET, torch.Generator(device=dev).manual_seed(0), dev)

    # surgery = checkpoint rewrite: convert once, set n in the config
    cfg0, params = from_pretrained_hf(hf, softmax_n_param=0.0, device=dev)
    cfg1, _ = from_pretrained_hf(hf, softmax_n_param=args.n, device=dev)

    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, hf.config.vocab_size, size=(1, 12))).to(dev)
    with torch.no_grad():
        out0 = xlnet_forward(params, cfg0, ids)["last_hidden_state"]
        out1 = xlnet_forward(params, cfg1, ids)["last_hidden_state"]
        _, taps = xlnet_forward(params, cfg1, ids, collect_taps=True)
    delta = float((out1 - out0).abs().max())

    if args.model:
        # the reference's invariant: n = 0 is HF
        with torch.no_grad():
            hf_out = hf(input_ids=ids.cpu()).last_hidden_state
        err0 = float((out0.cpu() - hf_out).abs().max())
        print(f"n=0 vs HF max abs err: {err0:.2e}  (parity)")
    print(f"n={args.n} vs n=0 max abs delta: {delta:.3f}  (surgery active)")

    # per-layer attention-output stats, the outlier measurement workflow
    variances = {name: float(t.float().var()) for name, t in taps.items()}
    for name, var in variances.items():
        print(f"  {name}: var={var:.4f}")
    return delta, variances


if __name__ == "__main__":
    main()
