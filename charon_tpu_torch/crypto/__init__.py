"""Host-side BLS12-381 primitives the port needs: plain Python over ints,
copied from the reference so the port stands alone."""
