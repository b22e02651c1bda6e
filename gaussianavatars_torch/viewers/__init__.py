"""Headless viewer core (`local.AvatarViewerCore`), the orbit camera and keyframe timeline
(`orbit`), and the training monitor's wire protocol (`network_gui`)."""
