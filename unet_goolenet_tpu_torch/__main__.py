"""`python -m unet_goolenet_tpu_torch <command>`: one dispatcher over the CLI apps.

Counterpart of the JAX package's `__main__.py`, with the same commands,
usage text and exit codes (`--help` exits 0; no command or an unknown one
exits 2 with the usage on stderr). The reference ships four bare scripts
run from two working directories (分割/main.py, 分割/predict.py,
分类/ROI_main.py, 分类/test.py); here every workflow hangs off the package.
Each command imports its app only when it runs, so `--help` stays quick
and `serve --artifact` imports no model code.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "train-seg": ("unet_goolenet_tpu_torch.apps.train_seg",
                  "stage-1 UNet segmentation training (分割/main.py)"),
    "predict-seg": ("unet_goolenet_tpu_torch.apps.predict_seg",
                    "stage-1 batch mask prediction (分割/predict.py)"),
    "train-cls": ("unet_goolenet_tpu_torch.apps.train_cls",
                  "stage-2 GoogLeNet grading training (分类/ROI_main.py)"),
    "infer-e2e": ("unet_goolenet_tpu_torch.apps.infer_e2e",
                  "two-stage end-to-end grading (分类/test.py)"),
    "serve": ("unet_goolenet_tpu_torch.apps.serve",
              "production HTTP serving host (micro-batching)"),
    "export": ("unet_goolenet_tpu_torch.apps.export_serving",
               "export the serving graph as a torch.export artifact"),
}


def _usage() -> str:
    width = max(len(name) for name in COMMANDS)
    lines = [f"  {name:<{width}}  {desc}" for name, (_, desc) in COMMANDS.items()]
    return ("usage: python -m unet_goolenet_tpu_torch <command> [args...]\n\n"
            "commands:\n" + "\n".join(lines) +
            "\n\nRun `python -m unet_goolenet_tpu_torch <command> --help` for command args.")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_usage())
        raise SystemExit(0)
    if not argv:   # an error: the usage on stderr, as for an unknown command
        print(_usage(), file=sys.stderr)
        raise SystemExit(2)
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    module, _ = COMMANDS[cmd]
    importlib.import_module(module).main(rest)


if __name__ == "__main__":
    main()
