"""Operations and bytes of the program's work, from shapes: the arithmetic
behind the roofline and MFU metrics, frozen with the benchmark."""
