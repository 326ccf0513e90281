"""Sparse experts (Mixtral): the port's ``MoEConfig``, with the prefill
capacity the configuration file states under ``assumed``."""

#: a prefill forward keeps one expert capacity over all its rows
ROWS_COUPLED = True


def port_config(conf: dict, common: dict):
    from tpu_docker_api_torch.models import MoEConfig

    return MoEConfig(n_experts=conf["num_local_experts"],
                     top_k=conf["num_experts_per_tok"],
                     capacity_factor=float(
                         conf["assumed"]["capacity_factor"]),
                     **common)
