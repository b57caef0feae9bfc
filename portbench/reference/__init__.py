"""Plain PyTorch references of the configurations' models, one module a
reference, named by a configuration's ``reference`` key. They import
nothing of the program under test."""
