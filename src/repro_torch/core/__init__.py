"""repro_torch.core — BuffetFS: the paper's contribution, the port's own copy
of `repro.core` (the same modules and public names, protocol, wire bytes,
on-disk layout and RPC counts; standard library only, every import within
the package relative, so its servers answer with its own handlers alone).

User-level distributed file system that eliminates the open() RPC by
leveraging permission checks to clients (cached directory tree with 10-byte
per-entry permission records), deferring open-state recording onto the first
data RPC, and executing close() asynchronously — plus the Lustre-Normal and
Lustre-DoM baseline protocol simulations the paper evaluates against.
"""
from .bagent import (BAgent, DEFAULT_CACHE_BLOCK, DEFAULT_CACHE_BUDGET,
                     TreeNode)
from .baselines import LustreDoMClient, LustreNormalClient
from .blib import BLib, BuffetFile
from .bserver import BServer
from .cluster import BuffetCluster, ClusterConfig
from .inode import Inode
from .perms import (Credentials, FSError, O_CREAT, O_RDONLY, O_RDWR, O_TRUNC,
                    O_WRONLY, PermRecord, R_OK, W_OK, X_OK, access_ok)
from .service import Operation, OperationRegistry, SERVER_OPS
from .transport import InProcTransport, LatencyModel, TCPTransport, ZERO_LATENCY
from .wire import (EPOCHSTALE, Message, MsgType, RpcStats, batch_status,
                   pack_batch, unpack_batch)

__all__ = [
    "BAgent", "DEFAULT_CACHE_BLOCK", "DEFAULT_CACHE_BUDGET", "TreeNode",
    "LustreDoMClient", "LustreNormalClient", "BLib",
    "BuffetFile", "BServer", "BuffetCluster", "ClusterConfig", "Inode",
    "Credentials", "FSError", "PermRecord", "access_ok",
    "O_CREAT", "O_RDONLY", "O_RDWR", "O_TRUNC", "O_WRONLY",
    "R_OK", "W_OK", "X_OK",
    "InProcTransport", "LatencyModel", "TCPTransport", "ZERO_LATENCY",
    "EPOCHSTALE", "Message", "MsgType", "RpcStats",
    "Operation", "OperationRegistry", "SERVER_OPS",
    "batch_status", "pack_batch", "unpack_batch",
]
