from omnigs_torch.scene.keyframe import Keyframe  # noqa: F401
from omnigs_torch.scene.scene import Scene  # noqa: F401
