"""Zero-shot or checkpoint evaluation (counterpart of ``valor_tpu/cli/evaluate.py``).

    python -m valor_tpu_torch.cli.evaluate --config X.json --checkpoint <run dir> \
        [--zero_shot true] [--device cpu]

``cli.train``'s ``main`` with ``--zero_shot true`` appended unless the caller
set it (the reference's ``--zero_shot`` path, train.py:74-79): the evaluation
flows run once and nothing is trained.  ``--device`` passes through.
"""

from __future__ import annotations

import sys

from valor_tpu_torch.cli.train import main as train_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--zero_shot" not in " ".join(argv):
        argv += ["--zero_shot", "true"]
    return train_main(argv)


if __name__ == "__main__":
    main()
