"""The port's examples (``examples/torch_*.py``) run on the CPU, and the
port's files import nothing of JAX.

Each example's ``main`` runs in this process with ``--cpu`` at a small size
(``torch_train`` spawns a two-rank gloo world); without a card and without
``--cpu`` each raises instead of falling back to the CPU. An ``ast`` scan
holds every file of the port package, the examples, ``chip_smoke.py`` and
the 7B line to imports of neither ``jax`` nor the JAX package.
"""

import ast
import importlib
import json
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("torch_serve", "torch_train", "torch_finetune_surgery",
            "torch_surgery_and_analysis", "torch_xlnet_surgery")

torch.set_num_threads(2)


@pytest.fixture
def examples(monkeypatch):
    # spawned ranks import torch_train by name from the same path
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    return {name: importlib.import_module(name) for name in EXAMPLES}


def test_serve(examples):
    done = examples["torch_serve"].main(["--cpu", "--batch", "4"])
    assert len(done) == 8 and all(len(r.output) == 32 for r in done)
    assert all(0 <= t < 32000 for r in done for t in r.output)


def test_train_in_a_two_rank_gloo_world(examples):
    losses = examples["torch_train"].main(["--cpu", "--world", "2", "--steps", "2",
                                           "--batch", "4", "--seq", "32"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # an untrained 1024-word model starts near ln(1024)
    assert abs(losses[0] - math.log(1024)) < 1.0


def test_finetune_surgery(examples):
    losses, tokens = examples["torch_finetune_surgery"].main(
        ["--cpu", "--steps", "2", "--batch", "2", "--seq", "32"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert len(tokens) == 8 and all(0 <= t < 256 for t in tokens)


def test_surgery_and_analysis(examples, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the report goes to ./results
    act, report, path = examples["torch_surgery_and_analysis"].main(["--cpu"])
    assert Path(path).resolve() == tmp_path / "results" / "bert_softmax_n.json"
    names = [f"encoder.layer.{i}.attention.output" for i in range(2)]
    assert sorted(act) == names and all(act[n]["n_samples"] == 1 for n in names)
    assert sorted(report) == names
    saved = json.loads(Path(path).read_text())
    assert saved["activations"] == act and saved["weights"]


def test_xlnet_surgery(examples):
    delta, variances = examples["torch_xlnet_surgery"].main(["--cpu"])
    assert 0 < delta < 1 and len(variances) == 2
    assert all(math.isfinite(v) and v > 0 for v in variances.values())


@pytest.mark.parametrize("name", EXAMPLES)
def test_without_a_card_an_example_raises(examples, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        examples[name].main([])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _port_files():
    files = sorted((ROOT / "flash_attention_softmax_n_tpu_torch").rglob("*.py"))
    files += [ROOT / "examples" / f"{name}.py" for name in EXAMPLES]
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flash_attention_softmax_n_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
