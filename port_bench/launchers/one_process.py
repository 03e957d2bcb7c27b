"""One process on the first card: the whole run of the cell here."""

from port_bench.core import harness


def launch(root, cell, args, t_start) -> dict:
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return harness.run_cell(root, cell, args.seed, args.seconds,
                            bool(args.trace), device, t_start)
