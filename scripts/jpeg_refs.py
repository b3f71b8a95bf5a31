#!/usr/bin/env python3
"""Write the JPEG references that ``chip_smoke.py`` phase 11 holds a
machine's native JPEG decode to (``vcoder_tpu_torch/data/jpeg_refs.json``).

For every JPEG of phase 11's COST tree (``chip_smoke.JPEG_FILES``) it records
PIL's decode (``Image.open(...).convert("RGB")``) as its shape, channel
means and 16x16 box-averaged thumbnail (``chip_smoke.jpeg_ref``). PIL is
needed here, not on the machine that runs phase 11.

    python3 scripts/jpeg_refs.py           # (re)write the file
    python3 scripts/jpeg_refs.py --check   # exit 1 unless the file is current
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import JPEG_FILES, JPEG_REFS, jpeg_ref  # noqa: E402


def references() -> dict:
    return {name: jpeg_ref(np.asarray(Image.open(os.path.join(REPO, name)).convert("RGB")))
            for name in JPEG_FILES}


def main() -> int:
    refs = references()
    path = os.path.join(REPO, JPEG_REFS)
    if "--check" in sys.argv:
        with open(path) as f:
            current = json.load(f) == json.loads(json.dumps(refs))
        print(f"{JPEG_REFS}: {'current' if current else 'STALE'}")
        return 0 if current else 1
    with open(path, "w") as f:
        json.dump(refs, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {JPEG_REFS}: {len(refs)} files, {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
