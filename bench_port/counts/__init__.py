"""Operations and bytes counted from shapes."""
