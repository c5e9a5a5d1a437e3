"""Round-5 bench A/B: tracked-fps + tracked_frac of bench.py's tracked
bench under config variants (isolates which r5 tracker change moved the
easy-scene number).

    python tools/diag_bench_ab.py --band-lo 0.12 --band-hi 8.0
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--band-lo", type=float, default=None)
    ap.add_argument("--band-hi", type=float, default=None)
    args = ap.parse_args()

    from tinyslam.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import bench
    import tinyslam.config as C

    if args.band_lo is not None:
        orig = C.VOConfig

        class Patched(orig):  # type: ignore[misc]
            pass

        # frozen dataclass: easiest override is default replacement
        import dataclasses

        C.VOConfig = dataclasses.make_dataclass(
            "VOConfig",
            [(f.name, f.type,
              dataclasses.field(default=(
                  args.band_lo if f.name == "tri_band_lo" else
                  args.band_hi if f.name == "tri_band_hi" else f.default)))
             for f in dataclasses.fields(orig)],
            bases=(C._JsonMixin,), frozen=True)
        C.SlamConfig.__dataclass_fields__["vo"].default_factory = C.VOConfig

    out = bench.bench_tracked()
    print(json.dumps({
        "band_lo": args.band_lo, "band_hi": args.band_hi,
        "tracked_fps": round(out["tracked_fps"], 1),
        "tracked_frac": round(out["tracked_frac"], 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
