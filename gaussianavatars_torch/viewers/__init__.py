"""Headless viewer core (`local.AvatarViewerCore`) and the orbit camera and keyframe timeline (`orbit`)."""
