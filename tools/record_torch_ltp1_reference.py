"""Record the JAX package's LTP1 streams of the natural fixture's states.

For every case of tests/fixtures/torch_port_natural_reference.npz that
holds the full serializer state (``state_q``), runs
``limg_tpu.bitstream.serialize_from_state`` on JAX's state, with entropy
coding on and off, and writes each stream's SHA-256 and length to
tests/fixtures/torch_port_ltp1_reference.json. The native factor path and
the NumPy one (``LIMG_TPU_DISABLE_NATIVE_FACTOR=1``) must write the same
bytes; the tool fails if they do not.

    JAX_PLATFORMS=cpu python tools/record_torch_ltp1_reference.py

It runs no encode and no Pallas kernel (a few seconds). ``state_of`` and
``reference_streams`` are plain NumPy / JSON, so the port's tests and
chip_smoke.py read the recorded streams without JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.record_torch_merged_reference import config_kwargs  # noqa: E402
from tools.record_torch_natural_reference import CASES, OUT as NATURAL_FIXTURE  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_ltp1_reference.json")
# the fixture's cases that hold the full serializer state
STATE_CASES = [name for name, case in CASES.items() if case[4]]
ENTROPY = {"entropy": True, "raw": False}


def state_of(fx, name: str) -> dict:
    """The serializer state of case ``name`` in the natural fixture ``fx``
    (an opened .npz): what JAX's ``encode_image_merged(return_state=True)``
    returned."""
    make, levels, over, _, _ = CASES[name]
    img = make()
    channels = 4 if over.get("has_alpha") else 3
    return dict(height=img.shape[0], width=img.shape[1], num_levels=levels, channels=channels,
                rows=fx[f"{name}.state_rows"], q=fx[f"{name}.state_q"],
                n_runs=int(fx[f"{name}.n_runs"]))


def digest(blob: bytes) -> dict:
    return {"sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob)}


def reference_streams() -> dict:
    """case -> {"entropy" | "raw": {"sha256", "bytes"}}, as recorded."""
    with open(OUT) as f:
        return json.load(f)["cases"]


def main():
    from limg_tpu.bitstream import serialize_from_state
    from limg_tpu.config import EncodeConfig

    fx = np.load(NATURAL_FIXTURE)
    cases = {}
    for name in STATE_CASES:
        cfg = EncodeConfig(**config_kwargs(CASES[name][2]))
        state = state_of(fx, name)
        cases[name] = {}
        for key, entropy in ENTROPY.items():
            os.environ.pop("LIMG_TPU_DISABLE_NATIVE_FACTOR", None)
            blob = serialize_from_state(state, cfg, entropy=entropy)
            os.environ["LIMG_TPU_DISABLE_NATIVE_FACTOR"] = "1"
            if serialize_from_state(state, cfg, entropy=entropy) != blob:
                raise SystemExit(f"{name} {key}: the native and NumPy factor paths differ")
            cases[name][key] = digest(blob)
            print(name, key, cases[name][key], flush=True)
    os.environ.pop("LIMG_TPU_DISABLE_NATIVE_FACTOR", None)
    meta = dict(
        command="JAX_PLATFORMS=cpu python tools/record_torch_ltp1_reference.py",
        jax_path="limg_tpu.bitstream.serialize_from_state(state, cfg, entropy=...) on the "
                 "serializer state of tests/fixtures/torch_port_natural_reference.npz "
                 "(state_rows, state_q); native and NumPy factor paths equal",
        cases=cases,
    )
    with open(OUT, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
