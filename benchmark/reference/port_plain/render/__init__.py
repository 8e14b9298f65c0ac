"""Scene containers and IO, and the render pipeline."""
