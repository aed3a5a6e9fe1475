"""Host-side helpers of the preprocessing CLIs."""
from rald_torch.utils.concurrent import AsyncWorkerPool, imap_tqdm, shell_cmd, thread_map
from rald_torch.utils.interpolate import interp_pose

__all__ = ["AsyncWorkerPool", "imap_tqdm", "interp_pose", "shell_cmd", "thread_map"]
