"""Content fingerprint of the accuracy proxy's corpus (counterpart of
scripts/corpus_fingerprint.py::hash_corpus).

Seeds of the proxy are comparable only if every run trains and evaluates on
the same corpus, which is rendered anew each time. A scene's digest is a
sha256 over its frames and its ``poses.txt`` / ``K.txt`` bytes:

  - training and validation scenes (``train/``): the dtype, shape and bytes
    of each array of each ``.npz``, exactly as the JAX script hashes them,
    so they are held to the recorded ``docs/corpus_fingerprint.json``;
  - evaluation scenes (``eval/``): the dtype, shape and bytes of each PNG's
    decoded pixels (``data/io.py::read_png``). The JAX script hashes the
    PNG bytes that cv2 wrote, which another PNG writer cannot match; the
    pixel digests of that corpus are pinned in ``proxy_eval_pixels.json``
    beside this module.

    python -m dvmvs_tpu_torch.apps.corpus_fingerprint --root build/data_synth \\
        --expect docs/corpus_fingerprint.json \\
        --expect-pixels dvmvs_tpu_torch/apps/proxy_eval_pixels.json
    python -m dvmvs_tpu_torch.apps.corpus_fingerprint --root DIR --write FILE

Exit code 1 when a checked part differs from its record.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys
from typing import Dict

import numpy as np

from dvmvs_tpu_torch.data.io import read_png

EVAL_PIXELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "proxy_eval_pixels.json")


def _update_array(h, arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())


def hash_scene(scene_dir: str) -> str:
    h = hashlib.sha256()
    for f in sorted(glob.glob(os.path.join(scene_dir, "*.npz"))):
        with np.load(f) as z:
            for key in sorted(z.files):
                h.update(key.encode())
                _update_array(h, z[key])
    for f in sorted(glob.glob(os.path.join(scene_dir, "*", "*.png"))):
        h.update(os.path.relpath(f, scene_dir).encode())
        _update_array(h, read_png(f))
    for name in ("poses.txt", "K.txt"):
        p = os.path.join(scene_dir, name)
        if os.path.exists(p):
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def total_digest(scenes: Dict[str, str]) -> str:
    return hashlib.sha256(json.dumps(scenes, sort_keys=True).encode()).hexdigest()


def hash_corpus(root: str) -> dict:
    """Per-scene digests (a scene is a folder holding ``poses.txt``) and
    their total."""
    scene_dirs = sorted(os.path.dirname(p) for p in
                        glob.glob(os.path.join(root, "**", "poses.txt"), recursive=True))
    scenes = {os.path.relpath(sd, root): hash_scene(sd) for sd in scene_dirs}
    return {"total": total_digest(scenes), "scenes": scenes}


def _part(scenes: Dict[str, str], top: str) -> Dict[str, str]:
    return {k: v for k, v in scenes.items() if k.replace(os.sep, "/").split("/")[0] == top}


def compare(fingerprint: dict, recorded: dict, top: str) -> list:
    """Problems of the ``top`` part (``train`` or ``eval``) of the corpus
    against a record: scenes that differ, are missing, or are not in the
    record. Empty when they agree."""
    have, want = _part(fingerprint["scenes"], top), _part(recorded["scenes"], top)
    problems = [f"{s}: differs" for s in sorted(have) if s in want and have[s] != want[s]]
    problems += [f"{s}: missing" for s in sorted(want) if s not in have]
    problems += [f"{s}: not in the record" for s in sorted(have) if s not in want]
    if not have and not want:
        problems.append(f"no {top}/ scenes")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True)
    ap.add_argument("--write", default=None, help="record the fingerprint to this JSON file")
    ap.add_argument("--expect", default=None,
                    help="hold the train/ scenes to this record (docs/corpus_fingerprint.json)")
    ap.add_argument("--expect-pixels", default=None,
                    help="hold the eval/ scenes to this record of decoded pixels")
    args = ap.parse_args(argv)

    fp = hash_corpus(args.root)
    print(json.dumps({"total": fp["total"], "n_scenes": len(fp["scenes"])}), flush=True)
    if args.write:
        with open(args.write, "w") as f:
            json.dump(fp, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.write}")
    failed = False
    for path, top in ((args.expect, "train"), (args.expect_pixels, "eval")):
        if path is None:
            continue
        with open(path) as f:
            problems = compare(fp, json.load(f), top)
        if problems:
            failed = True
            print(f"corpus {top}/ MISMATCH against {path}: " + "; ".join(problems),
                  file=sys.stderr)
        else:
            print(f"corpus {top}/ matches {path}")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
