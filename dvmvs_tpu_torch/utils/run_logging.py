"""Training-run observability (counterpart of dvmvs_tpu/utils/run_logging.py).

The reference logs to tensorboardX and snapshots all source into code.zip
per run (dvmvs/train.py:47-77, dvmvs/utils.py:279-291). Here: JSONL scalar
logs (one line per event, trivially plottable) and the same code snapshot.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Dict


class RunLogger:
    def __init__(self, run_directory: str):
        self.run_directory = run_directory
        os.makedirs(run_directory, exist_ok=True)
        self._f = open(os.path.join(run_directory, "metrics.jsonl"), "a")

    def log(self, step: int, tag: str, values: Dict[str, float], **extra):
        self._f.write(json.dumps({
            "step": int(step), "tag": tag, "time": time.time(),
            **{k: float(v) for k, v in values.items()},
            **{k: float(v) for k, v in extra.items()},
        }) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def snapshot_code(run_directory: str):
    """Zip every .py of the package into <run>/code.zip
    (reference: dvmvs/utils.py:279-291)."""
    package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    zip_path = os.path.join(run_directory, "code.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _, files in os.walk(package_root):
            if "__pycache__" in root:
                continue
            for f in files:
                if f.endswith(".py"):
                    full = os.path.join(root, f)
                    z.write(full, os.path.relpath(full, os.path.dirname(package_root)))
    return zip_path
