from shadow_tpu_torch.cpu_ref.bulk_ref import CpuRefBulk
from shadow_tpu_torch.cpu_ref.netstack_ref import CoDelRef, TokenBucketRef
from shadow_tpu_torch.cpu_ref.sim import CpuRefPhold
from shadow_tpu_torch.cpu_ref.tgen_ref import CpuRefTgen

__all__ = ["CpuRefPhold", "CpuRefBulk", "CpuRefTgen", "CoDelRef", "TokenBucketRef"]
