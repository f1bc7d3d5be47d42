"""The reference's two headline workflows with the port, in one script:

1. SURGERY: take a pretrained HF BERT and rewrite it to softmax-1
   attention, as a checkpoint conversion plus a config rewrite
   (``surgery.from_pretrained_hf``, no monkey-patching).
2. ANALYSIS: stream activation statistics (kurtosis, skewness, variance,
   mean) through the model, write the reference-compatible JSON report
   (``results/bert_softmax_n.json``) and run the quantization gates.

The PyTorch port's counterpart of ``examples/surgery_and_analysis.py``. By
default the BERT is a stand-in built offline from bert-tiny's config and a
seeded state dict (``utils.standin``); ``--model PATH`` loads a local HF
checkpoint instead (needs ``transformers``; nothing is downloaded). Runs on
the card, or with ``--cpu`` through the kernels' plain versions::

    python examples/torch_surgery_and_analysis.py
    python examples/torch_surgery_and_analysis.py --cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

# bert-tiny's shape (HF BertConfig attributes)
TINY_BERT = dict(model_type="bert", vocab_size=30522, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=512, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, position_embedding_type="absolute",
                 is_decoder=False, add_cross_attention=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help="a local HF BERT checkpoint (needs transformers); omit for an "
                         "offline stand-in of bert-tiny")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--softmax-n", type=float, default=1.0)
    args = ap.parse_args(argv)

    from flash_attention_softmax_n_tpu_torch._device import resolve_device
    from flash_attention_softmax_n_tpu_torch.analysis import (
        activation_stats_to_dict,
        compute_weight_statistics,
        register_activation_hooks,
        save_results,
    )
    from flash_attention_softmax_n_tpu_torch.models import bert_forward
    from flash_attention_softmax_n_tpu_torch.quant import gate_report
    from flash_attention_softmax_n_tpu_torch.surgery import from_pretrained_hf
    from flash_attention_softmax_n_tpu_torch.utils.standin import standin

    dev = resolve_device("cpu" if args.cpu else None)
    if args.model:
        import transformers
        print(f"loading {args.model} ...")
        hf = transformers.AutoModel.from_pretrained(args.model, local_files_only=True)
    else:
        print("building a stand-in of bert-tiny (offline mode)")
        hf = standin(TINY_BERT, torch.Generator(device=dev).manual_seed(0), dev)

    # --- surgery: softmax_0 -> softmax_n as a checkpoint rewrite ---------
    cfg, params = from_pretrained_hf(hf, softmax_n_param=args.softmax_n, device=dev)
    print(f"surgery applied: {cfg.n_layers} layers, softmax_n={cfg.softmax_n}")

    ids = torch.tensor([[101, 7592, 2088, 102, 0, 0]], device=dev)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0]], device=dev)

    # --- analysis: streaming activation stats + weight stats -------------
    # bert_forward's tap names (examples/surgery_and_analysis.py passes the
    # decoder's "layers.{i}..." names, which collect nothing from a BERT)
    layer_names = [f"encoder.layer.{i}.attention.output" for i in range(cfg.n_layers)]
    hooked, stats = register_activation_hooks(
        lambda toks, m: bert_forward(params, cfg, toks, attention_mask=m,
                                     collect_taps=True),
        layer_names=layer_names, device=dev)
    with torch.no_grad():
        _, stats = hooked(stats, ids, mask)
    act = activation_stats_to_dict(stats)
    if not all(v["n_samples"] > 0 for v in act.values()):
        raise RuntimeError(f"no activations were collected: {act}")
    weights = compute_weight_statistics(params)
    report = gate_report(act)
    print("activation kurtosis per layer:",
          {k: round(v["kurtosis"], 2) for k, v in act.items()})
    print("quantization gates:", report)
    path = save_results({"activations": act, "weights": weights}, "bert_softmax_n")
    print(f"wrote {path}")
    return act, report, path


if __name__ == "__main__":
    main()
