"""Fill the ``--synthetic-cache`` of a training run without training (port
of ``tools/warm_cache.py``).

    python -m loans_tpu_torch.cli.warm_cache synthetic:2048 synthetic:32768 synthetic:512 \\
        --seed 3 --synthetic-assets 256 --assessor-low-iou 0.25 --assessor-pipeline stn \\
        --crop-size 75 75 --synthetic-cache /data/loans_cache

It takes the flags of ``cli.train_localizer`` (only those that shape the
data matter) and runs only its ``build_datasets``, which writes each
synthetic split under the key a later training run with the same flags
reads. Generating the recipe's assessor pool of 32768 crops is minutes of
host time, spent again at the start of every run and every supervised
resume (``cli.supervise`` passes the child's argv on unchanged, so a run
given ``--synthetic-cache`` resumes from the warmed entries); warming the
cache for the next run can overlap training the current one.

``--device`` (default ``cuda``) is where ``--assessor-pipeline stn``
renders the reference crops: K1's forward kernel on the card, its plain
version with ``--device cpu``. A missing card is refused as the training
CLI refuses it. The cache key holds no device, as the JAX package's
holds none, so that each package reads the other's files: a cache warmed
on the CPU serves a run on the card, and its ``stn`` crops may then differ
from what the card would render by one uint8 step where a sample lies
halfway between two pixels (a float32 value at a .5 boundary, which sums
in another order round to either side): 1.33e-3 of the pixels of 512
crops of 224² scenes at 75² on an NVIDIA H100 80GB HBM3.

It runs as one process: under ``torchrun`` there is nothing to share out.
"""

from __future__ import annotations

import time

from loans_tpu_torch.cli.train_localizer import build_datasets, get_parser, start_devices


def main(argv=None) -> tuple:
    """Build (and cache) the run's datasets; returns (train, reference,
    val) as ``build_datasets`` gives them."""
    args = get_parser().parse_args(argv)
    if not args.synthetic_cache:
        raise SystemExit("--synthetic-cache is required (nothing to warm)")
    start_devices(args)
    t0 = time.time()
    train, reference, val = build_datasets(args)
    print(
        f"warmed cache in {time.time() - t0:.0f}s: "
        f"train={len(train)} reference={len(reference)} val={len(val)} "
        f"-> {args.synthetic_cache}"
    )
    return train, reference, val


if __name__ == "__main__":
    main()
