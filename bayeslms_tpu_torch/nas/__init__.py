"""DARTS architecture search (the supernets, the architect, the search
loop), counterpart of ``bayeslms_tpu/nas``."""
