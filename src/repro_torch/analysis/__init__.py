"""Static-analysis tier for the port's concurrency and kernel contracts.

The port is a concurrent runtime (router workers, a hedge monitor, one
``EngineLoop`` thread per tier, submitter threads) whose lock contracts are
written as ``# guarded by:`` and ``# locklint: blocking-ok`` annotations,
and whose kernels follow ground rules around every CUDA entry point (no
fallback, no environment switch, every launch checked and counted). This
package checks them:

- ``locklint``     lock-discipline linter: guarded fields only touched under
                   their lock; no blocking calls, device dispatch or
                   host-device syncs while a strict lock is held; module-level
                   locks (the kernel library's build and count locks) as well
                   as instance locks.
- ``lockorder``    static may-acquire-under graph + cycle (deadlock) detection;
                   emits a dot/JSON artifact (``docs/lock_order_torch.*``)
                   that doubles as documentation.
- ``witness``      runtime instrumented Lock/RLock recording *actual*
                   acquisition order during the concurrency soaks and checking
                   it against the static graph.
- ``kernelcheck``  the CUDA wrappers' contract: ops.py/ref.py pairs, C entry
                   points that exist and report launch errors, wrappers that
                   check and count every launch, no fallback, in-place pools,
                   a card test and a JAX parity test per family.

Everything is stdlib-``ast`` based and imports neither torch nor JAX. Run
the whole tier with ``python -m repro_torch.analysis`` (see
``scripts/ci_torch.sh analyze``).
"""

from .common import Finding, SourceFile  # noqa: F401
