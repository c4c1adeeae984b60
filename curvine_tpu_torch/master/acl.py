"""The master's permission gate: the superuser only.

A carve of ``curvine_tpu/master/acl.py``: ``UserCtx.from_req`` (:42-44)
reads a request's user (none means ``root``) and groups, and
``SuperuserGate.check`` passes the superuser, or a member of the
supergroup, as the reference's ``AclEnforcer._is_super`` bypass does,
and refuses any other caller with ``PermissionDenied``. The reference
checks owner, group and mode bits on every path for the others; that
check is not ported (ROADMAP A3d), so the gate refuses them all, and it
never grants what the mode-bit check would deny."""

from __future__ import annotations

from dataclasses import dataclass, field

from curvine_tpu_torch.common import errors as err


@dataclass
class UserCtx:
    user: str = "root"
    groups: list[str] = field(default_factory=list)

    @staticmethod
    def from_req(q: dict) -> "UserCtx":
        return UserCtx(user=q.get("user") or "root",
                       groups=list(q.get("groups") or []))


class SuperuserGate:
    def __init__(self, superuser: str = "root",
                 supergroup: str = "supergroup"):
        self.superuser = superuser
        self.supergroup = supergroup

    def check(self, q: dict) -> UserCtx:
        """The request's caller, if it is the superuser; raises
        otherwise."""
        ctx = UserCtx.from_req(q)
        if ctx.user != self.superuser and self.supergroup not in ctx.groups:
            raise err.PermissionDenied(
                f"user={ctx.user}: the port's master serves the superuser "
                f"{self.superuser!r} only; permission checks for other "
                f"users are not ported (ROADMAP A3d)")
        return ctx
