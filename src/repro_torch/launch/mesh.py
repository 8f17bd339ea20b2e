"""Production meshes, as abstract meshes: the counterpart of
``repro/launch/mesh.py``.

The JAX package builds device meshes for its dry-run and its federated
runtime.  The port runs on one card and has no multi-card mesh: a mesh here
is an ``AbstractMesh``, the axis names and sizes that partition specs are
computed against (``launch/shardings.py``, ``models/partition.py``) and
that the roofline divides by (``tools/roofline.py``).  Nothing allocates or
distributes across cards.

Mesh roles (shared with the federated runtime, ``federation/mesh_roles.py``):
  single pod   (16, 16)      -> ("data", "model")       256 chips
  multi-pod    (2, 16, 16)   -> ("pod", "data", "model") 512 chips
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis name -> size, in mesh order."""

    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def make_test_mesh(num_devices: int) -> AbstractMesh:
    """The small (data, model) mesh of the dry-run selftest: ``model`` 2
    when ``num_devices`` is even, the rest on ``data``."""
    model = 2 if num_devices % 2 == 0 else 1
    return AbstractMesh({"data": num_devices // model, "model": model})


def make_vfl_mesh(parties: int, data_shards: int = 0) -> AbstractMesh:
    """The (data x party) grid of the ``vfl-*`` backends: ``parties`` on
    the model axis, ``data_shards`` row blocks on the data axis (0 = one
    block), as ``federation/mesh_roles.py`` lays them out on the one card."""
    if parties < 1 or data_shards < 0:
        raise ValueError(f"need parties >= 1 and data_shards >= 0, got "
                         f"{parties} and {data_shards}")
    return AbstractMesh({"data": max(data_shards, 1), "model": parties})


def batch_axes(mesh: AbstractMesh) -> tuple:
    """Axes the global batch shards over (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# Hardware constants of the roofline (tools/roofline.py), per card: NVIDIA
# H100 SXM (the card the port runs on reads "NVIDIA H100 80GB HBM3", power
# limit 700.00 W, in nvidia-smi). Data-sheet peaks, dense, at 700 W.
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12      # float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s per direction: NVLink 4 (18 links)
HBM_BYTES = 85_017_493_504   # torch.cuda.get_device_properties(0).total_memory
