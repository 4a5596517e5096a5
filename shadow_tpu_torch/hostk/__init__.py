"""hostk — the CPU-side host kernel: managed processes, syscall emulation,
and the shared-memory IPC with the LD_PRELOAD shim (native/shim/); port
of shadow_tpu/hostk/, copied, with the shim built into native/build-torch.

This is the rebuild of the reference's L0-L3 stack (reference:
src/lib/shim/, src/main/host/managed_thread.rs, src/main/host/syscall/):
real Linux binaries run under simulated time and exchange traffic through
the simulated network. The device engine (engine/) simulates
scripted hosts at tensor scale; hostk simulates *real processes* at CPU
scale; both share the graph/routing/determinism substrate.
"""

from shadow_tpu_torch.hostk.build import ensure_built, shim_lib_path, host_lib_path  # noqa: F401
