"""Operations and bytes of the benchmark's calls, counted from shapes."""
