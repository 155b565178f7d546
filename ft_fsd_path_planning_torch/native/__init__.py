"""Native (C++) runtime components: the replay-session loader."""

from ft_fsd_path_planning_torch.native.loader import load_session, replay_frames

__all__ = ["load_session", "replay_frames"]
