"""The ranks a launcher starts for a mesh (``launch/serve.py --gnn-mesh``,
``launch/train.py --debug-mesh``): one process a rank on this host, a file
rendezvous in a temporary directory, NCCL where every rank has a card of
its own and gloo otherwise (two gloo ranks share one card; NCCL refuses
two ranks of one communicator on a GPU).  Each rank joins the process
group and runs the launcher's ``main`` with the same arguments; ranks past
0 print nothing.  A rank that fails fails the launcher.
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile

import torch


def backend(device, world: int) -> str:
    """NCCL where every rank has a card of its own, gloo otherwise."""
    cuda = torch.device(device).type == "cuda"
    if cuda and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, main, world: int, backend_name: str, init_method: str,
               argv: list) -> None:
    """One rank: join the process group, run ``main(argv)``, leave."""
    import torch.distributed as dist

    if backend_name == "nccl":
        torch.cuda.set_device(rank)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group(backend_name, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        main(argv)
        # CUDA graphs that captured NCCL collectives go before their
        # communicators: destroying the process group while such a graph
        # lived hung it.  An executor frees its graphs with its last
        # reference (its forwards hold the mesh, not the executor); this
        # frees one that a cycle outside it, a caller's, still keeps
        gc.collect()
        # leave together: a rank that tore down its connections while
        # another still read the last collective's bytes aborted that rank
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if rank != 0:
            sys.stdout.close()
            sys.stdout = sys.__stdout__


def spawn(main, world: int, device, argv: list) -> str:
    """Start ``world`` ranks of ``main(argv)`` and wait for them (raises if
    one fails); -> the backend they used."""
    import torch.multiprocessing as tmp

    name = backend(device, world)
    if name == "nccl":
        # every rank on this host: NCCL bootstraps over the loopback (on a
        # machine whose other interfaces lead nowhere it hangs otherwise)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        tmp.start_processes(_rank_main, args=(main, world, name, init, argv),
                            nprocs=world, join=True, start_method="spawn")
    return name
