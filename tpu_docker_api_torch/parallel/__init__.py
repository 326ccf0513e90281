"""Parallelism layer of the port (counterpart of
``tpu_docker_api/parallel/``): the device mesh, the sharding rules, ring
and Ulysses attention over the ``sp`` axis, and the pipeline.

One process per device; the axes are the JAX package's:

- ``dp``   — data parallel (gradients all-reduced),
- ``fsdp`` — data parallel with parameter and optimizer sharding
  (ZeRO-3: a layer's weights are all-gathered where it runs, their
  gradients reduce-scattered),
- ``tp``   — tensor parallel (Megatron column/row splits),
- ``sp``   — sequence parallel (ring or Ulysses attention),
- ``ep``   — expert parallel (MoE experts sharded),
- ``pp``   — pipeline parallel (parallel/pipeline.py: GPipe and 1F1B
  over point-to-point sends; imported from there, as it needs the
  Llama model).
"""

from tpu_docker_api_torch.parallel.mesh import (  # noqa: F401
    AXES,
    Mesh,
    MeshPlan,
    build_mesh,
    single_device_mesh,
)
from tpu_docker_api_torch.parallel.ring import ring_attention  # noqa: F401
from tpu_docker_api_torch.parallel.sharding import (  # noqa: F401
    LLAMA_RULES,
    P,
    batch_spec,
    constrain,
    distribute_params,
    param_shardings,
    param_specs,
    spec_for,
)
from tpu_docker_api_torch.parallel.ulysses import ulysses_attention  # noqa: F401,E501
