"""didbl generator, its blocks, the kernel forward and the registry."""
