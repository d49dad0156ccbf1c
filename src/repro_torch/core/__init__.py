"""EconoServe core: the scheduler and its host-side building blocks, copied
from the reference with only the package name changed in imports."""
