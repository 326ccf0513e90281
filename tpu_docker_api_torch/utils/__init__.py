"""Cross-cutting utilities (parity: reference ``utils/``): the port's copy
of ``tpu_docker_api/utils/``."""

from tpu_docker_api_torch.utils.files import copy_dir_contents, dir_size  # noqa: F401
