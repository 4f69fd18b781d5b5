"""The pretraining CLI in this process (under ``torchrun``: this rank's),
for ``tests/test_torch_pretrain_parallel.py``: the port only (no JAX).

    python tests/torch_pretrain_runner.py <out> <pretrain_backbone argv>

Writes the dict ``cli.pretrain_backbone.main`` returns as
``<out>.<rank>.json``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loans_tpu_torch.cli import pretrain_backbone  # noqa: E402


def main():
    out, argv = sys.argv[1], sys.argv[2:]
    result = pretrain_backbone.main(argv)
    with open(f"{out}.{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
