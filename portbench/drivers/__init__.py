"""The drivers that run a traffic mix, each named by the mix's ``driver``."""
