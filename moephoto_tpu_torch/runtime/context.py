"""Worker-side task context: the shared-memory image exchange, progress
root and stop flag live here so pipeline code can reach them without
threading arguments everywhere."""

from io import BytesIO


class _Context:
    def __init__(self):
        self.root = None
        self.shared = None
        self.sharedView = None
        self.notifier = None
        self.stopFlag = None
        self.imageMode = "RGB"
        self.palette = None

    def getFile(self, size):
        return BytesIO(bytes(self.sharedView[:size]))


context = _Context()
