"""CLI entry point: ``python -m pinc_tpu input.ini [section:key=value ...]``.

Mirrors the reference binary's interface (``iniOpen``, src/io.c:254-311):
positional ini file, any number of ``section:key=value`` overrides, and the
special ``getnp`` argument that prints the number of devices the deck wants
(product of grid:nSubdomains) and exits — used by the mpinc.sh-style
launcher.  The run mode is selected from ``methods:mode`` exactly like
src/main.c:32-36.
"""

from __future__ import annotations

import sys

from .config import PincConfig, required_np
from .registry import RUN_MODES
from .utils.logging import STATUS, msg


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m pinc_tpu <input.ini> [getnp] "
              "[section:key=value ...]", file=sys.stderr)
        return 2

    ini_path, args = argv[0], argv[1:]
    overrides = [a for a in args if a != "getnp"]
    cfg = PincConfig.from_file(ini_path, overrides)

    if "getnp" in args:
        print(required_np(cfg))
        return 0

    from .utils.jaxconfig import enable_compilation_cache
    enable_compilation_cache()

    # import for registry side effects
    from . import simulation  # noqa: F401

    # [msgfiles] parse dump (reference iniOpen, src/io.c:280-301): record
    # how the input was parsed, after CLI overrides
    if any(k.startswith("msgfiles:") for k in cfg.keys()):
        from .utils.logging import MsgFiles
        out_dir = cfg.get_str("files:output", "")
        base = out_dir if out_dir.endswith("/") else "."
        mf = MsgFiles(cfg, output_dir=base or ".")
        for key in sorted(cfg.keys()):
            mf.write("parsedump", "%s = %s\n", key, cfg.get_str(key))
        mf.close()

    run = RUN_MODES.select(cfg, "methods:mode", default="regular")
    msg(STATUS, "pinc_tpu started: %s", ini_path)
    run()
    msg(STATUS, "pinc_tpu finished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
