"""Training-log parsing, the reference's figure-pipeline contract (JAX
counterpart ``utils/parse_logs.py``, copied: it needs no JAX).

Reference: ``FullPrecision/Figures/parse.py:8-43`` — regex-parses the trainer's
text logs (``Model_name:`` headers + ``| end of epoch … | valid loss … |
Loss pred len …`` lines) into per-model loss curves for the thesis figures.
The port's ``Trainer`` emits the same format, so these parsers work on the
reference's SLURM logs, the JAX package's logs and the port's.
"""

from __future__ import annotations

import re
from typing import Dict

MODEL_RE = re.compile(r"^Model_name:\s+(.+)")
EPOCH_RE = re.compile(
    r"\| end of epoch\s+(\d+)\s+\|\s+.*\|\s+valid loss\s+([\d.eE+-]+)\s+"
    r"\| Loss pred len\s+(.+)"
)
BATCH_RE = re.compile(
    r"\| epoch\s+(\d+) \|\s+(\d+)/\s*(\d+) batches \| lr ([\d.eE+-]+) \| "
    r"ms/batch\s+([\d.]+) \| loss\s+([\d.]+)"
)


def parse_log_text(text: str) -> Dict[str, dict]:
    """Parse a full training log into
    ``{model_name: {"epochs": [...], "valid_loss": [...], "split": [[...]],
    "ms_per_batch": [...]}}``."""
    results: Dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = MODEL_RE.match(line)
        if m:
            current = m.group(1).strip()
            results[current] = {
                "epochs": [], "valid_loss": [], "split": [], "ms_per_batch": []
            }
            continue
        if current is None:
            continue
        m = EPOCH_RE.match(line)
        if m:
            epoch, vloss, split_str = m.groups()
            split = [
                float(s)
                for s in re.findall(r"\d+:\s+([\d.]+)", split_str)
            ]
            results[current]["epochs"].append(int(epoch))
            results[current]["valid_loss"].append(float(vloss))
            results[current]["split"].append(split)
            continue
        m = BATCH_RE.match(line)
        if m:
            results[current]["ms_per_batch"].append(float(m.group(5)))
    return results


def parse_log_file(path: str) -> Dict[str, dict]:
    with open(path) as f:
        return parse_log_text(f.read())


def final_valid_losses(parsed: Dict[str, dict]) -> Dict[str, float]:
    """Last valid loss per model — the number the reference figures plot."""
    return {
        name: data["valid_loss"][-1]
        for name, data in parsed.items()
        if data["valid_loss"]
    }
