"""CLI: ``python -m paddle_tpu_torch.analysis --self-check``.

Runs every seeded fixture (each pass must fire exactly its intended code),
the clean flagship sweeps (no active finding) and the exemption-liveness
check, the sections above one rank and the roofline's drift gate, plus
the Concurrency Doctor's block; prints a JSON report and exits
non-zero on any failure.  ``--seeded-only`` skips the flagship sweeps (the
quick mode).  ``--device cuda`` runs it on the card (default: the CPU, at
the debug shapes).
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" not in argv and "--seeded-only" not in argv:
        print(__doc__)
        return 2
    device = "cpu"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value (cpu or cuda)", file=sys.stderr)
            return 2
        device = argv[i + 1]
    from .self_check import self_check

    res = self_check(clean="--seeded-only" not in argv, device=device)
    print(json.dumps(res, indent=1, default=str))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
