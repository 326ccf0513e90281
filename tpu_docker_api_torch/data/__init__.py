"""Token-file data layer of the port (counterpart of
``tpu_docker_api/data``)."""

from tpu_docker_api_torch.data.loader import (  # noqa: F401
    TokenSource,
    make_batch_fn,
    open_token_files,
)
