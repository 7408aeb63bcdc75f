from .checkpoint import (COMMIT_MARKER, CheckpointManager,  # noqa: F401
                         ChecksumError)
