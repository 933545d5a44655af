"""BuffetFS inode numbers — §3.2 "Namespace and Metadata Handling".

The paper re-modifies the inode to contain three segments:
  (1) hostID        — the server storing the actual file data
  (2) fileID        — unique per-server file identifier
  (3) version       — server incarnation number (reboot / restore detection)

We pack them into a single 64-bit integer so an inode travels anywhere a
plain `st_ino` would:

    [ hostID : 12 bits ][ version : 12 bits ][ fileID : 40 bits ]

12 bits of hostID = 4096 storage servers; 12 bits of version = 4096
incarnations per server (wraps); 40 bits of fileID = 1T files per server.
The client maps (hostID, version) -> server address via its local
configuration (`repro_torch.core.cluster.ClusterConfig`), which is how BuffetFS
gets away with no central metadata service.
"""
from __future__ import annotations

from typing import NamedTuple

HOST_BITS = 12
VER_BITS = 12
FILE_BITS = 40

MAX_HOST = (1 << HOST_BITS) - 1
MAX_VER = (1 << VER_BITS) - 1
MAX_FILE = (1 << FILE_BITS) - 1


class Inode(NamedTuple):
    host_id: int
    version: int
    file_id: int

    def pack(self) -> int:
        assert 0 <= self.host_id <= MAX_HOST
        assert 0 <= self.file_id <= MAX_FILE
        v = self.version & MAX_VER
        return (self.host_id << (VER_BITS + FILE_BITS)) | (v << FILE_BITS) | self.file_id

    @staticmethod
    def unpack(ino: int) -> "Inode":
        return Inode(
            host_id=(ino >> (VER_BITS + FILE_BITS)) & MAX_HOST,
            version=(ino >> FILE_BITS) & MAX_VER,
            file_id=ino & MAX_FILE,
        )

    def with_version(self, version: int) -> "Inode":
        return Inode(self.host_id, version & MAX_VER, self.file_id)


ROOT_FILE_ID = 1  # fileID of the root directory on host 0
