"""The dense decoder (Llama, Mistral): the port's ``LlamaConfig``."""

#: whether a prefill forward's rows change one another's outputs
ROWS_COUPLED = False


def port_config(conf: dict, common: dict):
    from tpu_docker_api_torch.models import LlamaConfig

    return LlamaConfig(**common)
