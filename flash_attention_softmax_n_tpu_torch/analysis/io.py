"""Results as JSON files under ./results/.

Counterpart of ``flash_attention_softmax_n_tpu/analysis/io.py``: the same
default directory, file name and indentation, so that both packages write
the same bytes for the same results.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

__all__ = ["save_results", "load_results"]


def save_results(results: dict, model_name: str,
                 directory: Optional[str] = None) -> Path:
    """Write ``results`` to ``<directory>/<model_name>.json`` (mkdir -p)."""
    out_dir = Path(directory) if directory is not None else Path("./results")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{model_name}.json"
    with open(path, "w") as f:
        json.dump(results, f, indent=4)
    return path


def load_results(model_name: str, directory: Optional[str] = None) -> dict:
    out_dir = Path(directory) if directory is not None else Path("./results")
    with open(out_dir / f"{model_name}.json") as f:
        return json.load(f)
