"""Service layer: the explicit operation registry and the batch executor.

This replaces the old string-reflection dispatch (``getattr(self,
"_op_<name>")``) with a declarative registry shared by every server-side
protocol in the tree:

* **BuffetFS verbs** (LOOKUP_DIR, READ, CREATE, ...) register from
  `repro_torch.core.bserver`;
* **Lustre baseline verbs** (OPEN_RECORD, READ_INLINE) register from
  `repro_torch.core.baselines` — the baseline protocol lives with the baselines,
  not inside BServer;
* the **BATCH envelope** is executed here, generically, for any registered
  verb: unpack N sub-messages, dispatch each, repack N sub-responses with a
  per-sub-message status vector.  Servers gain batching without any verb
  knowing it can be batched.

An `Operation` entry also carries a `mutating` flag so generic machinery
(stats, future journaling/replication) can classify verbs without parsing
handler bodies, and a `barrier` flag marking durability barriers (FSYNC):
a replication/journaling layer must not acknowledge a barrier verb until
every previously-applied mutation for the same object is stable.

Lease bookkeeping is a registry concern too: `grants_lease` marks verbs
whose response may carry a read-lease grant (READ), and `breaks_lease`
marks verbs that must recall outstanding read leases before their mutation
is acknowledged (WRITE, TRUNCATE, UNLINK) — the revoke-before-ack ordering
that makes the client page cache strongly consistent.  FSYNC is a barrier
but NOT lease-breaking: it changes durability, never contents, so cached
blocks stay valid across it.
"""
from __future__ import annotations

import errno
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from .wire import (Message, MsgType, batch_status, error, pack_batch,
                   unpack_batch)

# Handler signature: (server, header, payload) -> response Message
Handler = Callable[[Any, Dict, bytes], Message]

# Hard ceiling on sub-messages per BATCH frame: bounds server memory per
# request and keeps one giant batch from monopolising a service thread.
MAX_BATCH = 4096

# Bound on LOOKUP_TREE descent; clients iterate if they need to go deeper.
MAX_TREE_DEPTH = 16


@dataclass(frozen=True)
class Operation:
    msg_type: MsgType
    handler: Handler
    mutating: bool = False
    barrier: bool = False  # durability barrier: orders behind prior mutations
    grants_lease: bool = False  # response may carry a read-lease grant
    breaks_lease: bool = False  # must revoke read leases before acking


class OperationRegistry:
    """Explicit MsgType -> handler table with decorator registration.

    One registry instance (`SERVER_OPS`) is shared by BServer and the Lustre
    baselines; `dispatch()` is the single entry point through which every
    request — batched or not — reaches a handler.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._ops: Dict[MsgType, Operation] = {}

    def register(self, msg_type: MsgType, *, mutating: bool = False,
                 barrier: bool = False, grants_lease: bool = False,
                 breaks_lease: bool = False) -> Callable[[Handler], Handler]:
        def deco(fn: Handler) -> Handler:
            if msg_type in self._ops:
                raise ValueError(f"duplicate handler for {msg_type.name}")
            self._ops[msg_type] = Operation(msg_type, fn, mutating, barrier,
                                            grants_lease, breaks_lease)
            return fn
        return deco

    def types(self) -> Iterable[MsgType]:
        return sorted(self._ops, key=int)

    def lease_breaking_types(self) -> Iterable[MsgType]:
        """The verbs that recall read leases before acking — what a client
        cache may be invalidated by (tests/doc tooling classify off this)."""
        return [t for t in self.types() if self._ops[t].breaks_lease]

    def operation(self, msg_type: MsgType) -> Optional[Operation]:
        return self._ops.get(msg_type)

    def dispatch(self, server: Any, msg: Message) -> Message:
        """Route one message (or a BATCH of them) to its handler(s)."""
        if msg.type is MsgType.BATCH:
            return self.dispatch_batch(server, msg)
        op = self._ops.get(msg.type)
        if op is None:
            return error(errno.ENOSYS, f"unsupported op {msg.type.name}")
        try:
            return op.handler(server, msg.header, msg.payload)
        except KeyError:
            return error(errno.ENOENT, "no such object")
        except OSError as e:
            return error(e.errno or errno.EIO, str(e))
        except Exception as e:  # malformed header field, etc.: the client
            # must get an error RESPONSE, not a hung request or dead
            # connection (a pipelined transport worker would otherwise die)
            return error(errno.EIO, f"internal error in {msg.type.name}: {e}")

    def dispatch_batch(self, server: Any, msg: Message) -> Message:
        """Generic batch executor: run every sub-message through `dispatch`
        and return a BATCH of sub-responses plus a status vector.

        Sub-messages execute sequentially in order, so a batched mutation
        burst keeps exactly the semantics of the same burst sent one RPC at
        a time — including the invalidate-before-apply blocking of §3.4
        (each CREATE still waits for watcher acks before mutating).  A
        nested BATCH is rejected rather than recursed.
        """
        try:
            subs = unpack_batch(msg)
        except Exception as e:  # malformed envelope
            return error(errno.EBADMSG, f"bad batch envelope: {e}")
        if len(subs) > MAX_BATCH:
            return error(errno.E2BIG, f"batch of {len(subs)} > {MAX_BATCH}")
        resps: List[Message] = []
        for sub in subs:
            if sub.type is MsgType.BATCH:
                resps.append(error(errno.EBADMSG, "nested batch"))
            else:
                resps.append(self.dispatch(server, sub))
        env = pack_batch(resps, {"status": batch_status(resps)})
        return env


# The shared server-side registry.  bserver.py registers the BuffetFS verbs,
# baselines.py registers the Lustre-simulation verbs.
SERVER_OPS = OperationRegistry("bserver")
