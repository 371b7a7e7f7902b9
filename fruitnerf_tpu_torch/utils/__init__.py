import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names the
    CPU. Asking for a card where torch finds none raises; nothing falls back
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch {torch.__version__} finds no CUDA "
            "card; pass --device cpu (device='cpu') to run on the CPU"
        )
    return dev


def mesh_devices(device: torch.device) -> list[torch.device]:
    """The devices ``--mesh`` shards over: every visible card (the twin's
    ``Mesh(jax.devices())``) when ``device`` is a card, else ``device``
    alone, a one-shard mesh."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]
