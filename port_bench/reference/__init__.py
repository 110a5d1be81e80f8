"""Plain float32 references, one module a model family. They import
neither JAX nor anything of the program under test."""
