"""``python -m tpu_docker_api_torch -c cfg.toml``: the port's control-plane
daemon (``daemon.py``), the counterpart of ``python -m tpu_docker_api``."""

from tpu_docker_api_torch.daemon import main

if __name__ == "__main__":
    main()
