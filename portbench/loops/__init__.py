"""Request loops, one module a traffic kind."""
