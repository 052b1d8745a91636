"""Run the JAX package's dry-run (``repro.launch.dryrun.run_one``) for
some pairs and write its records, for the port's dry-run test: run as a
script in a process of its own (it sets XLA_FLAGS for 512 host devices
before JAX loads).

    python tests/_jax_dryrun_dump.py OUT_DIR [--paged] ARCH:SHAPE ...

The production mesh is built with Auto axes: this JAX version makes
Explicit ones by default, which the package's sharding constraints
refuse, and it is the mesh's axis types alone that differ.  Records are
``OUT_DIR/{arch}_{shape}_pod16x16.json``, with the loop-aware collective
bytes by kind under ``roofline/coll_detail``.  ``--paged``: decode
shapes lower the paged serving-engine step.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.launch.dryrun as dryrun  # noqa: E402


def production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(axes))


def main():
    out_dir, rest = sys.argv[1], sys.argv[2:]
    paged = "--paged" in rest
    dryrun.make_production_mesh = production_mesh
    for pair in (a for a in rest if a != "--paged"):
        arch, shape = pair.split(":")
        dryrun.run_one(arch, shape, out_dir=out_dir, verbose=False,
                       paged=paged)


if __name__ == "__main__":
    main()
